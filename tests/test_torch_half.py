"""bf16 and f16 activations on the port's kernel paths, against the JAX package.

The JAX package's Pallas kernels take bf16 and f16 activations: K1/K2
dequantize each tile to the activation's dtype and sum exact products in
f32, K3/K4 sum the activations into f32 bins, K5 computes in f32.  The
port serves them on its f32 routes from the exact widening (the codebook
rounded to the activation's dtype for K1/K2), so every kernel engine is
held within ``1e-5`` of JAX (interpret mode, jitted); outputs in the
activation's dtype within one of its ulps.  Weights are seeded
dictionaries carried across as numpy; images are exact in both dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alexnet_conv as jcfg
from repro.core import conv as jcv
from repro.core import params as jpar
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.core import conv as tcv
from repro_torch.core import params as tpar
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pasm_matmul as tpm
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=1e-5, atol=1e-5)
DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
ULP = {"bfloat16": 2.0 ** -8, "float16": 2.0 ** -10}  # one ulp, relative
ENGINES = ("einsum", "kernel", "kernel_implicit", "pas_kernel",
           "pas_kernel_implicit", "pas_einsum", "auto")


def _half(x: np.ndarray, dtype: str):
    """``x`` rounded to ``dtype``, as the same values in both packages."""
    tdt, jdt = DTYPES[dtype]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.float().numpy()).astype(jdt)


def _shared(rng, kshape, bins=16):
    idx = rng.integers(0, bins, kshape).astype(np.uint8)
    cb = np.sort(rng.standard_normal(bins)).astype(np.float32) * \
        (kshape[1] * kshape[2] * kshape[3]) ** -0.5
    bias = (rng.standard_normal(kshape[0]) * 0.1).astype(np.float32)
    return (jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(bias)),
            tcv.ConvParams.shared(torch.from_numpy(idx), torch.from_numpy(cb),
                                  bias=torch.from_numpy(bias)))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("engine", ENGINES)
def test_conv_engines_take_half_images(dtype, engine):
    """Every conv engine on bf16/f16 images: shared with the fused pool,
    packed without."""
    rng = np.random.default_rng(len(engine))
    kw = dict(k=3, c_in=5, c_out=8, stride=1, padding="same", relu=True)
    jc, tc = jcv.Conv2D(**kw), tcv.Conv2D(**kw)
    pj, pt = _shared(rng, (8, 5, 3, 3))
    xt, xj = _half(rng.standard_normal((4, 5, 9, 9)).astype(np.float32), dtype)
    for (p_j, p_t), pool in (((pj, pt), 2), ((pj.pack(), pt.pack()), 1)):
        f = jax.jit(lambda x, p: jcv.conv2d(x, p, jc, engine=engine,
                                            interpret=True, pool=pool))
        want = np.asarray(f(xj, p_j).astype(jnp.float32))
        got = tcv.conv2d(xt, p_t, tc, engine=engine, pool=pool)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL,
                                   err_msg=f"{engine} pool {pool}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", ["kernel", "kernel_implicit", "pas_kernel", "auto"])
def test_cnn_forward_on_half_images(dtype, impl):
    """The smoke AlexNet on bf16/f16 images (Queue 3: the port raised on
    ``kernel_implicit``, ``pas_kernel`` and ``auto``)."""
    rng = np.random.default_rng(3)
    cj = dataclasses.replace(jcfg.smoke_config(), impl=impl)
    ct = dataclasses.replace(tcfg.smoke_config(), impl=impl)
    convs = [_shared(rng, (c.c_out, c.c_in, c.ky, c.kx)) for c, _ in jcnn.stages(cj)]
    feat = int(np.prod(jcnn.feature_shape(cj)))
    w = (rng.standard_normal((feat, cj.classes)) * feat ** -0.5).astype(np.float32)
    b = rng.standard_normal(cj.classes).astype(np.float32)
    qj = {"conv": [c[0] for c in convs], "head": {"w": jnp.asarray(w), "b": jnp.asarray(b)}}
    qt = {"conv": [c[1] for c in convs], "head": {"w": torch.from_numpy(w),
                                                  "b": torch.from_numpy(b)}}
    xt, xj = _half(rng.standard_normal((3, *cj.in_chw)).astype(np.float32), dtype)
    want = np.asarray(jax.jit(lambda q, x: jcnn.forward(q, x, cj, interpret=True))(qj, xj))
    got = tcnn.forward(qt, xt, ct)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("impl", ["kernel", "pas_kernel"])
@pytest.mark.parametrize("packed", [False, True])
def test_params_matmul_half(dtype, impl, packed):
    """``params.matmul`` on K1/K3 with bf16/f16 x: the output in x's dtype,
    within one of its ulps of JAX's (both round an f32 sum)."""
    rng = np.random.default_rng(5)
    K, N = 39, 24
    idx = rng.integers(0, 16, (K, N)).astype(np.uint8)
    cb = (np.sort(rng.standard_normal(16)) * 0.2).astype(np.float32)
    bias = np.linspace(-1, 1, N).astype(np.float32)
    pj = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(bias))
    pt = tpar.PasmParams.shared(torch.from_numpy(idx), torch.from_numpy(cb),
                                bias=torch.from_numpy(bias))
    if packed:
        pj, pt = pj.pack(), pt.pack()
    xt, xj = _half(rng.standard_normal((5, 3, K)).astype(np.float32), dtype)
    want = jax.jit(lambda x, p: jpar.matmul(x, p, impl=impl, relu=True,
                                            interpret=True))(xj, pj)
    got = tpar.matmul(xt, pt, impl=impl, relu=True)
    assert got.dtype == xt.dtype and want.dtype == xj.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=ULP[dtype], atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f16(causal):
    """K5 on f16 q/k/v (the port raised): the f32 route on the exact
    widening, the output rounded to f16 — JAX's kernel computes in f32."""
    rng = np.random.default_rng(7)
    B, S, H, KV, hd = 2, 40, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, KV, KV))
    (tq, jq), (tk, jk), (tv, jv) = (_half(a, "float16") for a in (q, k, v))
    tpm.reset_launches()
    want = jops.flash_attention(jq, jk, jv, causal=causal, bq=16, bk=16,
                                interpret=True)
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == torch.float16 and tpm.launches["flash_attention"] == 0
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=ULP["float16"], atol=1e-4)
