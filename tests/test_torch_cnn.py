"""The port's AlexNet stack and CnnBatcher against the JAX package, on the CPU.

The JAX package makes and quantizes the smoke-config weights; they are
carried across as numpy through :mod:`repro_torch.interop`, so both sides
hold the same dictionaries.  Logit tolerance ``rtol = atol = 1e-3`` is the
JAX suite's own kernel-vs-einsum tolerance (``tests/test_cnn.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alexnet_conv as jcfg
from repro.models import cnn as jcnn
from repro.serve.batcher import CnnBatcher as JaxCnnBatcher
from repro_torch import interop
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.models import cnn as tcnn
from repro_torch.serve.batcher import CnnBatcher, default_hw_buckets

TOL = dict(rtol=1e-3, atol=1e-3)


def _tree(params):
    """JAX CNN params flattened into the numpy tree interop takes."""
    arr = lambda a: None if a is None else np.asarray(a)
    convs = [dict(kind=p.kind, kshape=p.kshape, bins=p.bins, order=p.order,
                  pad_k=p.pad_k, kernel=arr(p.kernel), idx=arr(p.idx),
                  codebook=arr(p.codebook), bias=arr(p.bias))
             for p in params["conv"]]
    return {"conv": convs, "head": {k: arr(v) for k, v in params["head"].items()}}


def _pair(**over):
    cj = dataclasses.replace(jcfg.smoke_config(), **over)
    ct = dataclasses.replace(tcfg.smoke_config(), **over)
    pj = jcnn.init_params(cj, jax.random.PRNGKey(0))
    return cj, ct, pj


def _images(cfg, n=2, seed=1):
    C, H, W = cfg.in_chw
    x = np.random.default_rng(seed).standard_normal((n, C, H, W)).astype(np.float32)
    return x.transpose(0, 2, 3, 1).copy() if cfg.layout == "NHWC" else x


@pytest.mark.parametrize("impl,packed,layout,padding", [
    ("kernel", False, "NCHW", "valid_centred"),
    ("kernel_implicit", False, "NCHW", "valid_centred"),
    ("kernel", True, "NHWC", "same"),
    ("kernel_implicit", True, "NHWC", "same"),
    ("auto", True, "NCHW", "valid"),
])
def test_smoke_logits_match_jax(impl, packed, layout, padding):
    cj, ct, pj = _pair(impl=impl, packed=packed, layout=layout, padding=padding)
    qj = jcnn.quantize(pj, cj)
    qt = interop.cnn_params_from_numpy(_tree(qj), device="cpu")
    assert [p.kind for p in qt["conv"]] == ["packed" if packed else "shared"] * 3
    x = _images(cj)
    want = np.asarray(jcnn.forward(qj, jnp.asarray(x), cj, interpret=True))
    got = tcnn.forward(qt, torch.from_numpy(x), ct)
    assert tuple(got.shape) == (2, ct.classes)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dense_and_einsum_forward_match_jax():
    cj, ct, pj = _pair()
    pt = interop.cnn_params_from_numpy(_tree(pj), device="cpu")
    x = _images(cj)
    np.testing.assert_allclose(
        tcnn.forward_dense(pt, torch.from_numpy(x), ct).numpy(),
        np.asarray(jcnn.forward_dense(pj, jnp.asarray(x), cj)), **TOL)
    qj = jcnn.quantize(pj, cj)
    qt = interop.cnn_params_from_numpy(_tree(qj), device="cpu")
    ce, te = (dataclasses.replace(c, impl="einsum") for c in (cj, ct))
    np.testing.assert_allclose(
        tcnn.forward(qt, torch.from_numpy(x), te).numpy(),
        np.asarray(jcnn.forward(qj, jnp.asarray(x), ce)), **TOL)


def test_kernel_engines_bitwise_equal_on_cpu():
    """K1 and K2's plain versions walk the same products: the explicit and
    implicit engines give identical logits."""
    cj, ct, pj = _pair(packed=True)
    qt = interop.cnn_params_from_numpy(_tree(jcnn.quantize(pj, cj)), device="cpu")
    x = torch.from_numpy(_images(cj, n=3))
    y1 = tcnn.forward(qt, x, dataclasses.replace(ct, impl="kernel"))
    y2 = tcnn.forward(qt, x, dataclasses.replace(ct, impl="kernel_implicit"))
    assert torch.equal(y1, y2)


def test_port_init_and_quantize_on_cpu():
    """The port's own init + k-means path: shapes, kinds, and a quantized
    forward that tracks the dense one (as tests/test_cnn.py asserts)."""
    ct = tcfg.smoke_config()
    gen = torch.Generator().manual_seed(0)
    params = tcnn.init_params(ct, gen, device="cpu")
    assert tcnn.feature_shape(ct) == (32, 2, 2)
    assert tuple(params["head"]["w"].shape) == (128, ct.classes)
    w = params["conv"][0].kernel
    assert float(w.abs().max()) <= 2 * 27 ** -0.5 + 1e-6  # truncated at 2 std
    q = tcnn.quantize(params, ct)
    assert [p.kind for p in q["conv"]] == ["shared"] * 3
    assert all(tuple(p.codebook.shape) == (ct.bins,) for p in q["conv"])
    x = torch.randn((2, 3, 32, 32), generator=gen)
    dense = tcnn.forward_dense(params, x, ct).flatten()
    quant = tcnn.forward(q, x, ct).flatten()
    assert float(torch.corrcoef(torch.stack([dense, quant]))[0, 1]) > 0.9


def test_cnn_batcher_classes_match_jax():
    cj, ct, pj = _pair()
    qj = jcnn.quantize(pj, cj)
    qt = interop.cnn_params_from_numpy(_tree(qj), device="cpu")
    assert default_hw_buckets((32, 32)) == [(8, 8), (16, 16), (32, 32)]
    rng = np.random.default_rng(3)
    sizes = [(32, 32), (30, 20), (14, 18), (8, 8), (5, 7), (16, 16), (20, 31), (32, 32)]
    imgs = [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in sizes]
    bj = JaxCnnBatcher(cj, qj, max_batch=4)
    bt = CnnBatcher(ct, qt, max_batch=4, device="cpu")
    rj = [bj.submit(im) for im in imgs]
    rt = [bt.submit(im) for im in imgs]
    assert [r.bucket for r in rt] == [r.bucket for r in rj]
    bj.flush()
    served = bt.flush()
    assert len(served) == len(imgs) and all(r.done for r in rt)
    assert [r.cls for r in rt] == [r.cls for r in rj]
    assert bt.n_batches == 4  # 32×32: five images in two batches; 16×16: one; 8×8: two
    roll = bt.metrics.rollup()
    assert roll["cnn_n"] == len(imgs) and roll["img_s"] > 0
    with pytest.raises(ValueError):
        bt.submit(rng.standard_normal((3, 64, 64)).astype(np.float32))


def test_cnn_batcher_defaults_to_the_card(monkeypatch):
    """device=None means "cuda": without a card it raises, never falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CnnBatcher(tcfg.smoke_config(), {}, max_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcnn.init_params(tcfg.smoke_config(), torch.Generator())
