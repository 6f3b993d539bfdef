"""The port's paper-faithful PAS path against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions (Pallas kernels with
``interpret=True``, as ``tests/test_kernels.py`` runs them) and through the
port, whose K3/K4 wrappers run their plain versions on CPU tensors.
Tolerance ``rtol = atol = 1e-4`` against JAX: the two sum the f32 bins in
another order (tiles vs one product).  JAX's own ``pas_kernel`` and
``pas_kernel_implicit`` are not bit-identical under interpret mode (ROADMAP
Queue 3), so the port is held to JAX with a tolerance and to itself bitwise.
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
from repro.core import pas as jpas
from repro.core import pasm as jp
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import cnn as jcnn
from repro_torch import interop
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.core import conv as tcv
from repro_torch.core import params as tpar
from repro_torch.core import pas as tpas
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pas_histogram as tph
from repro_torch.kernels import pasm_matmul as tpm
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn

TOL = dict(rtol=1e-4, atol=1e-4)


def _tensor_pair(idx, cb, packed):
    """A JAX PASMTensor and its port twin from numpy (logical idx)."""
    K, N = idx.shape
    bins = cb.shape[1]
    if packed:
        idx = np.asarray(jp.pack_int4(jnp.asarray(idx)))
    meta = dict(shape=(K, N), bins=bins, bits=4 if packed else jp.bits_for_bins(bins),
                packed=packed)
    tj = jp.PASMTensor(idx=jnp.asarray(idx), codebook=jnp.asarray(cb), **meta)
    tt = interop.pasm_tensor_from_numpy(dict(idx=idx, codebook=cb, **meta), device="cpu")
    return tj, tt


def _conv_tree(p):
    arr = lambda a: None if a is None else np.asarray(a)
    return dict(kind=p.kind, kshape=p.kshape, bins=p.bins, order=p.order,
                pad_k=p.pad_k, kernel=arr(p.kernel), idx=arr(p.idx),
                codebook=arr(p.codebook), bias=arr(p.bias))


def _conv_pair(rng, k, c_in, c_out, bins, packed, layout, groups=1):
    order = "kkc" if layout == "NHWC" else "ckk"
    idx = rng.integers(0, bins, size=(c_out, c_in, k, k)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((groups, bins)).astype(np.float32), axis=1)
    bias = rng.standard_normal(c_out).astype(np.float32)
    kw = {"order": order} if groups > 1 else {}
    pj = jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb[0] if groups == 1 else cb),
                               bias=jnp.asarray(bias), **kw)
    if packed:
        pj = pj.pack(layout=layout)
    return pj, interop.conv_params_from_numpy(_conv_tree(pj), device="cpu")


# ---------------------------------------------------------------------------
# K3: ops.pas_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,bins,packed,bias,relu,pool", [
    (8, 64, 32, 16, False, False, False, 1),     # tests/test_kernels.py:110
    (16, 128, 64, 4, False, True, True, 1),
    (4, 256, 128, 16, True, False, True, 1),     # packed → unpacked for K3
    (8, 128, 48, 16, False, True, True, 1),      # tests/test_kernels.py:205
    (8, 2400, 64, 16, False, True, False, 1),    # K = 2400: JAX K-pads, port masks
    (16, 363, 24, 16, False, True, True, 2),     # odd K (conv1), pooled
    (36, 96, 17, 64, False, True, True, 3),      # ragged N, pool 3
])
def test_pas_matmul_matches_jax(M, K, N, bins, packed, bias, relu, pool):
    rng = np.random.default_rng(M * K + N + bins)
    idx = rng.integers(0, bins, size=(K, N)).astype(np.uint8)
    cb = rng.standard_normal((1, bins)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    tj, tt = _tensor_pair(idx, cb, packed)
    want = jops.pas_matmul(jnp.asarray(x), tj, interpret=True, relu=relu, pool=pool,
                           bias=None if b is None else jnp.asarray(b))
    tpm.reset_launches()
    got = tops.pas_matmul(torch.from_numpy(x), tt, relu=relu, pool=pool,
                          bias=None if b is None else torch.from_numpy(b))
    assert tuple(got.shape) == tuple(want.shape) == (M // (pool * pool), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not any(tpm.launches.values())  # the CPU path launches nothing
    # the PASM identity at the kernel level: K3 ≈ K1 on the same operands
    ws = tops.pasm_matmul(torch.from_numpy(x), tt, relu=relu, pool=pool,
                          bias=None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ws.numpy(), rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# K4: ops.pas_conv2d, and conv2d on the three PAS engines
# ---------------------------------------------------------------------------

_CONVS = [
    # (k, stride, c_in, c_out, padding, layout, hw, pool, bins, packed)
    (3, 2, 6, 8, "same", "NCHW", (11, 10), 2, 8, False),   # tests/test_conv_pool.py:78
    (3, 1, 5, 8, "same", "NHWC", (13, 11), 2, 16, True),   # odd K = 45 packs with pad
    (4, 2, 2, 5, "valid", "NCHW", (10, 9), 1, 16, True),
    (11, 4, 3, 7, "same", "NHWC", (23, 21), 2, 16, False),  # conv1-like
    (5, 1, 4, 70, "valid_centred", "NCHW", (9, 8), 1, 4, False),  # N > 32
]


@pytest.mark.parametrize("case", _CONVS, ids=lambda c: f"k{c[0]}s{c[1]}-{c[4]}-{c[5]}-p{c[7]}")
def test_pas_conv2d_matches_jax(case):
    k, s, c_in, c_out, padding, layout, (ih, iw), pool, bins, packed = case
    rng = np.random.default_rng(k * 100 + c_in + ih)
    pj, pt = _conv_pair(rng, k, c_in, c_out, bins, packed, layout)
    conv = dict(k=k, c_in=c_in, c_out=c_out, stride=s, padding=padding, layout=layout,
                relu=True)
    cj, ct = jcv.Conv2D(**conv), tcv.Conv2D(**conv)
    shape = (2, ih, iw, c_in) if layout == "NHWC" else (2, c_in, ih, iw)
    x = rng.standard_normal(shape).astype(np.float32)
    gj, gt = jcv.conv_geom(cj, ih, iw, pool=pool), tcv.conv_geom(ct, ih, iw, pool=pool)
    bias = np.array(pj.bias)
    want = jops.pas_conv2d(jnp.asarray(x), pj.gemm_tensor(layout), gj,
                           bias=jnp.asarray(bias), relu=True, interpret=True)
    got = tops.pas_conv2d(torch.from_numpy(x), pt.gemm_tensor(layout), gt,
                          bias=torch.from_numpy(bias), relu=True)
    assert tuple(got.shape) == tuple(want.shape) == (2, gt.P_out, c_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("engine", ["pas_kernel", "pas_kernel_implicit", "pas_einsum"])
def test_conv2d_pas_engines_match_jax(engine, packed):
    """tests/test_conv_pool.py:78's stage (SAME, stride 2, fused pool 2) on
    every PAS engine; inside the port the explicit and implicit PAS engines
    agree bitwise, and the fused pool equals the unfused one."""
    rng = np.random.default_rng(7)
    pj, pt = _conv_pair(rng, 3, 6, 8, 8, packed, "NCHW")
    conv = dict(k=3, c_in=6, c_out=8, stride=2, padding="same", relu=True)
    cj, ct = jcv.Conv2D(**conv), tcv.Conv2D(**conv)
    x = rng.standard_normal((2, 6, 11, 10)).astype(np.float32)
    want = jcv.conv2d(jnp.asarray(x), pj, cj, engine=engine, pool=2, interpret=True)
    got = tcv.conv2d(torch.from_numpy(x), pt, ct, engine=engine, pool=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert tcv.conv_plan(pt, ct, 11, 10, engine=engine, pool=2) == \
        jcv.conv_plan(pj, cj, 11, 10, engine=engine, pool=2)
    xt = torch.from_numpy(x)
    explicit = tcv.conv2d(xt, pt, ct, engine="pas_kernel", pool=2)
    assert torch.equal(tcv.conv2d(xt, pt, ct, engine="pas_kernel_implicit", pool=2),
                       explicit)
    if engine != "pas_einsum":
        assert torch.equal(tcv.conv2d(xt, pt, ct, engine=engine, pool=2,
                                      pool_impl="unfused"), explicit)


def test_alexnet_conv1_same_nhwc_pas_kernel():
    """tests/test_conv_api.py:117: torchvision AlexNet conv1 under SAME+NHWC
    on ``pas_kernel``, against JAX and the port's own implicit engine."""
    rng = np.random.default_rng(117)
    pj, pt = _conv_pair(rng, 11, 3, 96, 16, False, "NHWC")
    conv = dict(k=11, c_in=3, c_out=96, stride=4, padding="same", layout="NHWC",
                relu=True)
    cj, ct = jcv.Conv2D(**conv), tcv.Conv2D(**conv)
    x = rng.standard_normal((1, 224, 224, 3)).astype(np.float32)
    want = jcv.conv2d(jnp.asarray(x), pj, cj, engine="pas_kernel", interpret=True)
    got = tcv.conv2d(torch.from_numpy(x), pt, ct, engine="pas_kernel")
    assert tuple(got.shape) == (1, 56, 56, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert torch.equal(tcv.conv2d(torch.from_numpy(x), pt, ct,
                                  engine="pas_kernel_implicit"), got)


# ---------------------------------------------------------------------------
# params.matmul(impl="pas_kernel"), the groups rule, _pool_fusible
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K,packed", [(363, True), (64, False), (363, False)])
def test_params_matmul_pas_kernel(K, packed):
    """Packed odd K carries the §3 pad row (bin 0, zero activation)."""
    rng = np.random.default_rng(K)
    idx = rng.integers(0, 16, size=(K, 20)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((1, 16)).astype(np.float32), axis=1)
    x = rng.standard_normal((3, 4, K)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    pj = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(b))
    pt = tpar.PasmParams.shared(torch.from_numpy(idx), torch.from_numpy(cb),
                                bias=torch.from_numpy(b))
    if packed:
        pj, pt = pj.pack(), pt.pack()
        assert pt.pad_k == pj.pad_k == 1
    want = jpar.matmul(jnp.asarray(x), pj, impl="pas_kernel", relu=True, interpret=True)
    got = tpar.matmul(torch.from_numpy(x), pt, impl="pas_kernel", relu=True)
    assert tuple(got.shape) == (3, 4, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_ENTRY_POINTS = ["pas_kernel", "pas_kernel_implicit", "pas_einsum", "matmul"]


@pytest.mark.parametrize("entry", _ENTRY_POINTS)
def test_grouped_codebook_refused(entry):
    """The PAS formulation is single-dictionary: both packages raise the same
    ValueError on every PAS entry point."""
    rng = np.random.default_rng(3)
    pj, pt = _conv_pair(rng, 3, 4, 6, 16, False, "NCHW", groups=2)
    conv = dict(k=3, c_in=4, c_out=6)
    x = rng.standard_normal((2, 4, 7, 7)).astype(np.float32)
    if entry == "matmul":
        xm = rng.standard_normal((5, 36)).astype(np.float32)
        run_j = lambda: jpar.matmul(jnp.asarray(xm), pj._as_pasm("ckk"),
                                    impl="pas_kernel", interpret=True)
        run_t = lambda: tpar.matmul(torch.from_numpy(xm), pt._as_pasm("ckk"),
                                    impl="pas_kernel")
    else:
        run_j = lambda: jcv.conv2d(jnp.asarray(x), pj, jcv.Conv2D(**conv),
                                   engine=entry, interpret=True)
        run_t = lambda: tcv.conv2d(torch.from_numpy(x), pt, tcv.Conv2D(**conv),
                                   engine=entry)
    with pytest.raises(ValueError, match="single-dictionary") as ej:
        run_j()
    with pytest.raises(ValueError, match="single-dictionary") as et:
        run_t()
    assert str(et.value) == str(ej.value)


def test_pas_kernel_wrappers_refuse_grouped_and_grad():
    x = torch.randn(8, 32)
    idx = torch.randint(0, 16, (32, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="one dictionary"):
        tph.pas_matmul_kernel_call(x, idx, torch.randn(2, 16))
    with pytest.raises(RuntimeError, match="forward-only"):
        tph.pas_matmul_kernel_call(x.requires_grad_(), idx, torch.randn(1, 16))
    with torch.no_grad():  # inference on parameters is fine
        tph.pas_matmul_kernel_call(x, idx, torch.randn(1, 16))
    with pytest.raises(ValueError, match="window-major"):
        tph.pas_matmul_kernel_call(x.detach()[:6], idx, torch.randn(1, 16), pool=2)
    with pytest.raises(ValueError, match="device"):
        tph.pas_matmul_kernel_call(x.detach().to("meta"), idx.to("meta"),
                                   torch.randn(1, 16, device="meta"))
    conv = tcv.Conv2D(k=3, c_in=2, c_out=5)
    g = tcv.conv_geom(conv, 6, 6)
    with pytest.raises(ValueError, match="one dictionary"):
        tph.pas_conv_kernel_call(torch.randn(1, 2, 6, 6), torch.zeros(
            (18, 5), dtype=torch.uint8), torch.randn(3, 16), geom=g)
    assert tph.pas_plan(8, 32, 5, 16, 2).tile == 128
    assert tph.pas_plan(144, 32, 5, 16, 12).tile == 256
    with pytest.raises(ValueError, match="unfused"):
        tph.pas_plan(289, 32, 5, 16, 17)


@pytest.mark.parametrize("engine", ["einsum", "pas_einsum", "pas_kernel",
                                    "pas_kernel_implicit"])
def test_pool_fusible_matches_jax(engine):
    cj = jcv.Conv2D(k=3, c_in=2, c_out=4, padding="same")
    ct = tcv.Conv2D(k=3, c_in=2, c_out=4, padding="same")
    for pool in (1, 2, 3, 17):
        want = jcv._pool_fusible(engine, cj, 12, 12, pool, None)
        assert tcv._pool_fusible(engine, ct, 12, 12, pool) == want
    assert not tcv._pool_fusible("pas_einsum", ct, 12, 12, 2)


# ---------------------------------------------------------------------------
# out-of-range indices: the one-hot drops them
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bins", [4, 16])
def test_out_of_range_indices_dropped(bins):
    rng = np.random.default_rng(bins)
    K, N = 40, 12
    idx = rng.integers(0, bins + 6, size=(K, N)).astype(np.uint8)
    assert (idx >= bins).any()
    cb = rng.standard_normal((1, bins)).astype(np.float32)
    x = rng.standard_normal((8, K)).astype(np.float32)
    want = np.asarray(jref.pas_matmul_ref(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cb)))
    xt, it, ct = torch.from_numpy(x), torch.from_numpy(idx), torch.from_numpy(cb)
    np.testing.assert_allclose(tref.pas_matmul_ref(xt, it, ct).numpy(), want, **TOL)
    # the same as the in-range indices alone
    keep = np.where(idx < bins, idx, 0)
    w = np.where(idx < bins, cb[0][keep], 0.0).astype(np.float32)
    np.testing.assert_allclose(want, x @ w, **TOL)
    tj = jp.PASMTensor(idx=jnp.asarray(idx), codebook=jnp.asarray(cb), shape=(K, N),
                       bins=bins, bits=8, packed=False)
    jk = jops.pas_matmul(jnp.asarray(x), tj, interpret=True)
    np.testing.assert_allclose(np.asarray(jk), want, **TOL)
    got = tph.pas_matmul_kernel_call(xt, it, ct)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # K4's plain version over a 1x1 conv is the same product
    conv = tcv.Conv2D(k=1, c_in=K, c_out=N)
    g = tcv.conv_geom(conv, 2, 4)
    img = torch.from_numpy(np.ascontiguousarray(x.reshape(1, 2, 4, K).transpose(0, 3, 1, 2)))
    y4 = tph.pas_conv_kernel_call(img, it, ct, geom=g)
    np.testing.assert_allclose(y4.reshape(8, N).numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# core/pas.py against repro.core.pas
# ---------------------------------------------------------------------------


def test_paper_worked_example():
    """Fig 4 / Fig 6: result = 98.8 via both formulations, same bins."""
    x = np.array([26.7, 3.4, 4.8, 17.7, 6.1], np.float32)
    idx = np.array([0, 1, 2, 3, 0], np.uint8)
    cb = np.array([1.7, 0.4, 1.3, 2.0], np.float32)
    xt, it, ct = (torch.from_numpy(a) for a in (x, idx, cb))
    xj, ij, cj = (jnp.asarray(a) for a in (x, idx, cb))
    np.testing.assert_allclose(tpas.pas_accumulate(xt, it, 4).numpy(),
                               np.asarray(jpas.pas_accumulate(xj, ij, 4)), rtol=1e-6)
    for name in ("pasm_dot", "weight_shared_dot"):
        got = float(getattr(tpas, name)(xt, it, ct))
        assert np.isclose(got, float(getattr(jpas, name)(xj, ij, cj)), rtol=1e-6)
        assert np.isclose(got, 98.8, atol=0.05)
    # an index outside the bins is dropped by both
    ib = np.array([0, 1, 7, 3, 0], np.uint8)
    np.testing.assert_array_equal(
        tpas.pas_accumulate(xt, torch.from_numpy(ib), 4).numpy(),
        np.asarray(jpas.pas_accumulate(xj, jnp.asarray(ib), 4)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bit_exact_integer(seed):
    """§5.3: on integer-valued inputs PASM is bit-exact vs the weight-shared
    MAC, in both packages (f32 holds every partial sum exactly)."""
    rng = np.random.default_rng(seed)
    n, bins = 200, 16
    x = rng.integers(-1000, 1000, size=n).astype(np.float32)
    idx = rng.integers(0, bins, size=n).astype(np.uint8)
    cb = rng.integers(-1000, 1000, size=bins).astype(np.float32)
    xt, it, ct = (torch.from_numpy(a) for a in (x, idx, cb))
    direct = float(tpas.weight_shared_dot(xt, it, ct))
    assert float(tpas.pasm_dot(xt, it, ct)) == direct
    assert float(jpas.pasm_dot(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cb))) == direct
    assert direct == float(np.sum(x.astype(np.int64) * cb.astype(np.int64)[idx]))


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("bins", [4, 16, 64])
def test_pas_matmul_equivalence(groups, bins):
    rng = np.random.default_rng(groups * 100 + bins)
    idx = rng.integers(0, bins, size=(64, 48)).astype(np.uint8)
    cb = rng.standard_normal((groups, bins)).astype(np.float32)
    x = rng.standard_normal((8, 64)).astype(np.float32)
    tj, tt = _tensor_pair(idx, cb, bins == 16)
    xt = torch.from_numpy(x)
    want = np.asarray(jpas.pasm_matmul(jnp.asarray(x), tj))
    np.testing.assert_allclose(tpas.pasm_matmul(xt, tt).numpy(), want, **TOL)
    np.testing.assert_allclose(tpas.weight_shared_matmul(xt, tt).numpy(),
                               np.asarray(jpas.weight_shared_matmul(jnp.asarray(x), tj)),
                               **TOL)
    np.testing.assert_allclose(tpas.pasm_matmul(xt, tt).numpy(),
                               tpas.weight_shared_matmul(xt, tt).numpy(), **TOL)


def test_cycle_model_paper_example():
    """§2.2: 1024 inputs, B=16, 4 PAS sharing one MAC → 1088 cycles."""
    for n, b, p in [(1024, 16, 4), (1024, 16, 1), (363, 4, 2)]:
        assert tpas.pasm_cycles(n, bins=b, pas_per_mac=p) == jpas.pasm_cycles(
            n, bins=b, pas_per_mac=p)
        assert tpas.mac_cycles(n) == jpas.mac_cycles(n) == n
    assert tpas.pasm_cycles(1024, bins=16, pas_per_mac=4) == 1088


# ---------------------------------------------------------------------------
# the AlexNet smoke forward on impl="pas_kernel"
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("packed,layout", [(False, "NCHW"), (True, "NHWC")])
def test_smoke_forward_pas_kernel_matches_jax(packed, layout):
    over = dict(impl="pas_kernel", packed=packed, layout=layout)
    cj = dataclasses.replace(jcfg.smoke_config(), **over)
    ct = dataclasses.replace(tcfg.smoke_config(), **over)
    qj = jcnn.quantize(jcnn.init_params(cj, jax.random.PRNGKey(0)), cj)
    tree = {"conv": [_conv_tree(p) for p in qj["conv"]],
            "head": {k: np.asarray(v) for k, v in qj["head"].items()}}
    qt = interop.cnn_params_from_numpy(tree, device="cpu")
    C, H, W = cj.in_chw
    x = np.random.default_rng(1).standard_normal((2, C, H, W)).astype(np.float32)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    want = np.asarray(jcnn.forward(qj, jnp.asarray(x), cj, interpret=True))
    got = tcnn.forward(qt, torch.from_numpy(x), ct)
    assert tuple(got.shape) == (2, ct.classes)
    # the JAX suite's own kernel-vs-einsum tolerance for logits (five layers)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-3)
    ein = tcnn.forward(qt, torch.from_numpy(x), dataclasses.replace(ct, impl="einsum"))
    np.testing.assert_allclose(got.numpy(), ein.numpy(), rtol=1e-3, atol=1e-3)
