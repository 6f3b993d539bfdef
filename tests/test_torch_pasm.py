"""The port's weight-sharing core against the JAX package, on the CPU.

Integer results must match exactly: packed bytes, pad rows, byte counts,
geometry and dispatch decisions.  k-means is held with a tolerance (see
:func:`test_kmeans_codebooks_agree`).  Inputs are made with numpy from a
seed and handed to both packages.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import alexnet_conv as jcfg
from repro.core import conv as jcv
from repro.core import params as jpar
from repro.core import pasm as jp
from repro.models import cnn as jcnn
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.core import conv as tcv
from repro_torch.core import params as tpar
from repro_torch.core import pasm as tp
from repro_torch.models import cnn as tcnn


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("K,N", [(2, 1), (64, 7), (364, 96), (2400, 3)])
def test_pack_unpack_int4_byte_identical(K, N):
    idx = _rng(K).integers(0, 16, size=(K, N)).astype(np.uint8)
    pj = np.asarray(jp.pack_int4(jnp.asarray(idx)))
    pt = tp.pack_int4(torch.from_numpy(idx))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tp.unpack_int4(pt).numpy(), idx)
    np.testing.assert_array_equal(
        tp.unpack_int4(pt).numpy(), np.asarray(jp.unpack_int4(jnp.asarray(pj))))


def test_pack_int4_rejects_odd_k():
    with pytest.raises(ValueError):
        tp.pack_int4(torch.zeros((3, 2), dtype=torch.uint8))


@pytest.mark.parametrize("K,N,bins,groups", [
    (363, 96, 16, 1),   # AlexNet conv1's odd K: pad row → bin 0
    (363, 5, 8, 1),     # odd K, bins < 16: reserved zero bin appended
    (64, 9, 16, 2),     # grouped, even per-group length
    (2400, 4, 16, 1),   # AlexNet conv2's K
    (31, 3, 4, 1),
])
def test_pasm_params_pack_byte_identical(K, N, bins, groups):
    rng = _rng(K + bins)
    idx = rng.integers(0, bins, size=(K, N)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((groups, bins)).astype(np.float32), axis=1)
    bias = rng.standard_normal(N).astype(np.float32)
    pj = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb),
                                bias=jnp.asarray(bias)).pack()
    pt = tpar.PasmParams.shared(torch.from_numpy(idx), torch.from_numpy(cb),
                                bias=torch.from_numpy(bias)).pack()
    np.testing.assert_array_equal(pt.idx.numpy(), np.asarray(pj.idx))
    np.testing.assert_array_equal(pt.codebook.numpy(), np.asarray(pj.codebook))
    assert (pt.kind, pt.shape, pt.bins, pt.pad_k, pt.bits) == \
        (pj.kind, pj.shape, pj.bins, pj.pad_k, pj.bits)
    assert pt.nbytes_weights == pj.nbytes_weights
    assert pt.compression_ratio == pj.compression_ratio
    tj, tt = pj.gemm_tensor(), pt.gemm_tensor()
    assert (tt.shape, tt.bins, tt.bits, tt.packed) == (tj.shape, tj.bins, tj.bits, tj.packed)
    np.testing.assert_array_equal(pt.dense_matrix().numpy(),
                                  np.asarray(pj.dense_matrix()))


@pytest.mark.parametrize("kind", ["dense", "shared", "packed"])
def test_pasm_params_byte_accounting(kind):
    rng = _rng(7)
    w = rng.standard_normal((2, 33, 10)).astype(np.float32)  # leading stack dim
    if kind == "dense":
        pj = jpar.PasmParams.dense(jnp.asarray(w))
        pt = tpar.PasmParams.dense(torch.from_numpy(w))
    else:
        idx = rng.integers(0, 16, size=w.shape).astype(np.uint8)
        cb = rng.standard_normal((2, 1, 16)).astype(np.float32)
        pj = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb))
        pt = tpar.PasmParams.shared(torch.from_numpy(idx), torch.from_numpy(cb))
        if kind == "packed":
            pj, pt = pj.pack(), pt.pack()
            np.testing.assert_array_equal(pt.idx.numpy(), np.asarray(pj.idx))
        np.testing.assert_array_equal(pt.dense_matrix().numpy(),
                                      np.asarray(pj.dense_matrix()))
    assert pt.nbytes_weights == pj.nbytes_weights
    assert pt.nbytes_dense_bf16 == pj.nbytes_dense_bf16
    assert pt.compression_ratio == pj.compression_ratio


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kshape,bins,groups", [
    ((96, 3, 11, 11), 16, 1),   # AlexNet conv1: K = 363, odd
    ((8, 3, 11, 11), 8, 1),     # odd K with a reserved zero bin
    ((6, 4, 3, 3), 16, 2),      # grouped
    ((5, 3, 3, 3), 4, 1),
])
def test_conv_params_pack_byte_identical(kshape, bins, groups, layout):
    rng = _rng(sum(kshape) + bins)
    idx = rng.integers(0, bins, size=kshape).astype(np.uint8)
    cb = np.sort(rng.standard_normal((groups, bins)).astype(np.float32), axis=1)
    order = "kkc" if layout == "NHWC" else "ckk"
    kw = {"order": order} if groups > 1 else {}
    pj = jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb), **kw).pack(layout=layout)
    pt = tcv.ConvParams.shared(torch.from_numpy(idx), torch.from_numpy(cb), **kw
                               ).pack(layout=layout)
    np.testing.assert_array_equal(pt.idx.numpy(), np.asarray(pj.idx))
    np.testing.assert_array_equal(pt.codebook.numpy(), np.asarray(pj.codebook))
    assert (pt.kind, pt.kshape, pt.bins, pt.order, pt.pad_k) == \
        (pj.kind, pj.kshape, pj.bins, pj.order, pj.pad_k)
    np.testing.assert_array_equal(pt.gemm_tensor(layout).idx.numpy(),
                                  np.asarray(pj.gemm_tensor(layout).idx))
    np.testing.assert_array_equal(pt.dense_operand(layout).numpy(),
                                  np.asarray(pj.dense_operand(layout)))


@pytest.mark.parametrize("shape,bins,groups", [
    ((363, 16), 16, 1),
    ((256, 24), 8, 4),
    ((1000, 1), 16, 1),
    ((96, 40), 4, 2),
])
def test_kmeans_codebooks_agree(shape, bins, groups):
    """Codebooks agree to f32 rounding and >= 99.9 % of indices agree.

    The two packages take the Lloyd-step sums (``one_hot.T @ values``) in
    another order, so centroids may move by an ulp; a weight lying almost
    exactly on a bin edge can then flip to the neighbouring bin.  That is why
    the kernel and stack tests carry the JAX-produced indices across rather
    than re-running k-means.
    """
    w = _rng(shape[0] + bins).standard_normal(shape).astype(np.float32)
    cbj, ij = jp.kmeans_codebook(jnp.asarray(w), bins, groups=groups)
    cbt, it = tp.kmeans_codebook(torch.from_numpy(w), bins, groups=groups)
    assert it.dtype == torch.uint8 and tuple(cbt.shape) == (groups, bins)
    np.testing.assert_allclose(cbt.numpy(), np.asarray(cbj), rtol=1e-5, atol=1e-6)
    assert (it.numpy() == np.asarray(ij)).mean() >= 0.999


def test_quantize_dequantize_quantize_like_match():
    w = _rng(3).standard_normal((64, 12)).astype(np.float32)
    tj = jp.quantize(jnp.asarray(w), bins=16, groups=2)
    tt = tp.quantize(torch.from_numpy(w), bins=16, groups=2)
    assert (tt.shape, tt.bins, tt.bits, tt.packed, tt.groups) == \
        (tj.shape, tj.bins, tj.bits, tj.packed, tj.groups)
    assert tt.nbytes_weights == tj.nbytes_weights
    assert tt.compression_ratio == tj.compression_ratio
    # same dictionary on both sides → dequantize / quantize_like exactly equal
    tt = dataclasses.replace(tt, idx=torch.from_numpy(np.array(tj.idx)),
                             codebook=torch.from_numpy(np.array(tj.codebook)))
    np.testing.assert_array_equal(tp.dequantize(tt).numpy(), np.asarray(jp.dequantize(tj)))
    w2 = _rng(4).standard_normal((64, 12)).astype(np.float32)
    np.testing.assert_array_equal(tp.quantize_like(tt, torch.from_numpy(w2)).idx.numpy(),
                                  np.asarray(jp.quantize_like(tj, jnp.asarray(w2)).idx))
    assert tp.bits_for_bins(16) == jp.bits_for_bins(16) == 4
    assert tp.bits_for_bins(17) == jp.bits_for_bins(17) == 8
    with pytest.raises(ValueError):
        tp.bits_for_bins(257)


def test_kmeans_refuses_groups_over_the_quantile_cap():
    # torch.quantile's 2**24-element cap no longer bounds a group: the init
    # sorts once and the Lloyd steps walk the group in chunks
    big = torch.zeros((1 << 24) + 2, 1)
    big[::3] = 1.0
    cb, idx = tp.kmeans_codebook(big, 4, iters=1)
    assert tuple(cb.shape) == (1, 4) and tuple(idx.shape) == tuple(big.shape)
    assert torch.equal(tp.codebook_lookup(cb, idx), big)


_GEOMS = [(ih, iw, k, s, pad)
          for ih, iw in ((5, 5), (13, 11), (224, 224), (27, 27), (8, 9))
          for k, s in ((1, 1), (2, 2), (3, 1), (4, 2), (5, 1), (11, 4))
          for pad in ("valid_centred", "valid", "same")]


def test_conv_out_hw_and_plan_match_over_geometry_grid():
    """``conv_out_hw``, ``conv_geom`` and ``conv_plan``'s (engine, fused
    pool) decisions equal the JAX package's on every geometry."""
    rng = _rng(11)
    idx = rng.integers(0, 16, size=(4, 2, 11, 11)).astype(np.uint8)
    cb = rng.standard_normal(16).astype(np.float32)
    n = 0
    for ih, iw, k, s, pad in _GEOMS:
        kw = dict(k=k, c_in=2, c_out=4, stride=s, padding=pad)
        cj, ct = jcv.Conv2D(**kw), tcv.Conv2D(**kw)
        assert tcv.conv_out_hw(ih, iw, ct) == jcv.conv_out_hw(ih, iw, cj)
        pj = jcv.ConvParams.shared(jnp.asarray(idx[:, :, :k, :k]), jnp.asarray(cb))
        pt = tcv.ConvParams.shared(torch.from_numpy(idx[:, :, :k, :k].copy()),
                                   torch.from_numpy(cb))
        for pool in (1, 2, 3, 7):
            gj = jcv.conv_geom(cj, ih, iw, pool=pool)
            gt = tcv.conv_geom(ct, ih, iw, pool=pool)
            assert tuple(gt) == tuple(gj)
            assert (gt.P_out, gt.P_rows, gt.conv_k) == (gj.P_out, gj.P_rows, gj.conv_k)
            for engine in ("auto", "einsum", "kernel", "kernel_implicit"):
                for pool_impl in ("auto", "unfused"):
                    for batched in (True, False):
                        kw2 = dict(engine=engine, pool=pool, pool_impl=pool_impl,
                                   batched=batched)
                        assert tcv.conv_plan(pt, ct, ih, iw, **kw2) == \
                            jcv.conv_plan(pj, cj, ih, iw, **kw2)
                        n += 1
    assert n == len(_GEOMS) * 4 * 4 * 2 * 2


@pytest.mark.parametrize("padding", ["valid_centred", "valid", "same"])
def test_feature_shape_matches(padding):
    for name in ("config", "smoke_config"):
        cj = dataclasses.replace(getattr(jcfg, name)(), padding=padding)
        ct = dataclasses.replace(getattr(tcfg, name)(), padding=padding)
        assert tcnn.feature_shape(ct) == jcnn.feature_shape(cj)
        assert ct.in_chw == cj.in_chw and ct.classes == cj.classes
        assert ct.pools == cj.pools and ct.mesh_shape == cj.mesh_shape
        assert [(c.k, c.c_in, c.c_out, c.stride, c.relu) for c in ct.layers] == \
            [(c.k, c.c_in, c.c_out, c.stride, c.relu) for c in cj.layers]


def test_port_refuses_engines_of_later_slices():
    """mesh= takes the port's Mesh (tests/test_torch_sharding.py runs the
    sharded paths); anything else raises.  The PAS engines run
    (tests/test_torch_pas.py holds them against the JAX package)."""
    idx = torch.zeros((2, 1, 3, 3), dtype=torch.uint8)
    p = tcv.ConvParams.shared(idx, torch.arange(4, dtype=torch.float32))
    conv = tcv.Conv2D(k=3, c_in=1, c_out=2)
    x = torch.zeros((1, 1, 5, 5))
    for engine in ("kernel", "pas_kernel", "pas_kernel_implicit"):
        with pytest.raises(TypeError, match="Mesh"):
            tcv.conv2d(x, p, conv, engine=engine, mesh=object())
    with pytest.raises(TypeError, match="Mesh"):
        tpar.matmul(torch.zeros(2, 9), p._as_pasm("ckk"), impl="pas_kernel",
                    mesh=object())
    for engine in ("pas_kernel", "pas_kernel_implicit", "pas_einsum"):
        assert tuple(tcv.conv2d(x, p, conv, engine=engine).shape) == (1, 2, 3, 3)


@pytest.mark.parametrize("groups,nan_at", [(1, (3, 2)), (2, (3, 2)), (2, (40, 0))])
def test_quantize_propagates_nan_as_jax(groups, nan_at):
    """A weight group holding a NaN gets all-NaN centroids, as
    ``jnp.quantile``'s init gives JAX's k-means, so every weight of the
    group dequantizes to NaN (the port's sort-based init once left them
    finite and served the poisoned weight); the other group stays finite."""
    w = _rng(11).standard_normal((64, 6)).astype(np.float32)
    w[nan_at] = np.nan
    tj = jp.quantize(jnp.asarray(w), 16, groups=groups)
    tt = tp.quantize(torch.from_numpy(w), 16, groups=groups)
    dj = np.isnan(np.asarray(jp.dequantize(tj)))
    dt = np.isnan(tp.dequantize(tt).numpy())
    np.testing.assert_array_equal(dt, dj)
    g = nan_at[0] // (64 // groups)
    assert dt.reshape(groups, -1)[g].all() and dt.sum() == dt.size // groups
    assert np.isnan(tt.codebook[g].numpy()).all()
