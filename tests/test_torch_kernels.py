"""K1 and K2's plain versions (the port's CPU path) against the JAX kernels.

The JAX side runs ``repro.kernels.ops.pasm_matmul`` / ``pasm_conv2d`` with
``interpret=True``, as ``tests/test_kernels.py`` does.  Both packages get
the same numpy indices and codebooks.  Tolerance ``rtol = atol = 1e-4``:
the two sum the f32 products in a different order (tiles vs one product).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import conv as jcv
from repro.core import params as jpar
from repro.core import pasm as jp
from repro.kernels import ops as jops
from repro_torch import interop
from repro_torch.core import conv as tcv
from repro_torch.core import params as tpar
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pasm_matmul as tpm
from repro_torch.kernels import ref as tref

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
    """A JAX ConvParams flattened into the numpy dict interop takes."""
    arr = lambda a: None if a is None else np.asarray(a)
    return dict(kind=p.kind, kshape=p.kshape, bins=p.bins, order=p.order,
                pad_k=p.pad_k, kernel=arr(p.kernel), idx=arr(p.idx),
                codebook=arr(p.codebook), bias=arr(p.bias))


@pytest.mark.parametrize("M,K,N,bins,groups,packed,bias,relu,pool", [
    (8, 64, 32, 16, 1, True, False, False, 1),
    (16, 128, 96, 16, 4, True, True, True, 1),     # grouped + packed
    (5, 96, 17, 64, 2, False, True, False, 1),     # ragged M/N, uint8 indices
    (12, 2400, 40, 16, 1, False, True, True, 2),   # AlexNet conv2's K, pooled
    (36, 364, 24, 16, 1, True, True, True, 3),     # packed, pool 3
    (32, 48, 8, 8, 2, False, False, True, 2),
])
def test_k1_plain_matches_jax_kernel(M, K, N, bins, groups, packed, bias, relu, pool):
    rng = np.random.default_rng(M * K + N)
    idx = rng.integers(0, bins, size=(K, N)).astype(np.uint8)
    cb = rng.standard_normal((groups, bins)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    tj, tt = _tensor_pair(idx, cb, packed)
    want = jops.pasm_matmul(jnp.asarray(x), tj, interpret=True, relu=relu, pool=pool,
                            bias=None if b is None else jnp.asarray(b))
    got = tops.pasm_matmul(torch.from_numpy(x), tt, relu=relu, pool=pool,
                           bias=None if b is None else torch.from_numpy(b))
    assert tuple(got.shape) == tuple(want.shape) == (M // (pool * pool), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("K,bins,impl", [
    (363, 16, "kernel"),   # odd K packs with the §3 pad row (bin 0)
    (363, 8, "kernel"),    # odd K, reserved zero bin
    (64, 16, "dequant"),
    (64, 16, "dense"),
])
def test_params_matmul_packed_odd_k(K, bins, impl):
    rng = np.random.default_rng(K + bins)
    idx = rng.integers(0, bins, size=(K, 20)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((1, bins)).astype(np.float32), axis=1)
    x = rng.standard_normal((3, 4, K)).astype(np.float32)
    b = rng.standard_normal(20).astype(np.float32)
    pj = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(b)).pack()
    pt = tpar.PasmParams.shared(torch.from_numpy(idx), torch.from_numpy(cb),
                                bias=torch.from_numpy(b)).pack()
    want = jpar.matmul(jnp.asarray(x), pj, impl=impl, relu=True, interpret=True)
    got = tpar.matmul(torch.from_numpy(x), pt, impl=impl, relu=True)
    assert tuple(got.shape) == (3, 4, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


_CONVS = [
    # (k, stride, c_in, c_out, padding, layout, hw, pool, bins, groups, packed)
    (3, 1, 3, 8, "valid_centred", "NCHW", (9, 8), 2, 16, 1, True),    # K = 27, odd
    (3, 1, 3, 8, "same", "NHWC", (9, 8), 2, 16, 1, True),
    (4, 2, 2, 5, "valid_centred", "NCHW", (10, 9), 1, 8, 1, False),  # even kernel
    (4, 2, 2, 5, "valid", "NHWC", (10, 9), 1, 8, 2, False),
    (5, 1, 4, 6, "same", "NCHW", (7, 9), 2, 16, 2, True),            # grouped + packed
    (5, 2, 4, 6, "valid", "NCHW", (13, 11), 1, 16, 2, False),
    (11, 4, 3, 7, "same", "NHWC", (23, 21), 2, 16, 1, True),         # conv1-like
    (3, 1, 6, 70, "valid_centred", "NHWC", (6, 7), 1, 4, 3, False),  # N > 64
]


@pytest.mark.parametrize("case", _CONVS, ids=lambda c: f"k{c[0]}s{c[1]}-{c[4]}-{c[5]}-p{c[7]}")
def test_k2_plain_matches_jax_implicit_kernel(case):
    k, s, c_in, c_out, padding, layout, (ih, iw), pool, bins, groups, packed = case
    rng = np.random.default_rng(k * 100 + c_in + ih)
    order = "kkc" if layout == "NHWC" else "ckk"
    idx = rng.integers(0, bins, size=(c_out, c_in, k, k)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((groups, bins)).astype(np.float32), axis=1)
    bias = rng.standard_normal(c_out).astype(np.float32)
    kw = {"order": order} if groups > 1 else {}
    pj = jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(bias), **kw)
    if packed:
        pj = pj.pack(layout=layout)
    pt = interop.conv_params_from_numpy(_conv_tree(pj), device="cpu")
    conv = dict(k=k, c_in=c_in, c_out=c_out, stride=s, padding=padding, layout=layout,
                relu=True)
    cj, ct = jcv.Conv2D(**conv), tcv.Conv2D(**conv)
    shape = (2, ih, iw, c_in) if layout == "NHWC" else (2, c_in, ih, iw)
    x = rng.standard_normal(shape).astype(np.float32)
    gj, gt = jcv.conv_geom(cj, ih, iw, pool=pool), tcv.conv_geom(ct, ih, iw, pool=pool)
    want = jops.pasm_conv2d(jnp.asarray(x), pj.gemm_tensor(layout), gj,
                            bias=jnp.asarray(bias), relu=True, interpret=True)
    got = tops.pasm_conv2d(torch.from_numpy(x), pt.gemm_tensor(layout), gt,
                           bias=torch.from_numpy(bias), relu=True)
    assert tuple(got.shape) == tuple(want.shape) == (2, gt.P_out, c_out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the same stage through conv2d on both engines, fused pool vs JAX
    for engine in ("kernel", "kernel_implicit"):
        yj = jcv.conv2d(jnp.asarray(x), pj, cj, engine=engine, pool=pool, interpret=True)
        yt = tcv.conv2d(torch.from_numpy(x), pt, ct, engine=engine, pool=pool)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("pool", [1, 2, 3])
def test_patch_tile_is_window_major_im2col(layout, pool):
    """K2's gather (plain) equals the explicit path: im2col, then the
    window-major reorder, then the §3 pad column reading zero."""
    conv = tcv.Conv2D(k=3, c_in=3, c_out=4, stride=1, padding="same", layout=layout)
    shape = (2, 11, 10, 3) if layout == "NHWC" else (2, 3, 11, 10)
    x = torch.from_numpy(np.random.default_rng(pool).standard_normal(shape).astype(np.float32))
    g = tcv.conv_geom(conv, 11, 10, pool=pool)
    patches, (oh, ow) = tcv._im2col(x, conv)
    if pool > 1:
        patches = tcv._pool_order_patches(patches, 2, oh, ow, pool)
    tile = tpm.patch_tile(tpm._pad_image(x, g), 0, 0, geom=g, bm=g.P_rows,
                          bk=g.conv_k + 1)
    got = tile.reshape(2 * g.P_rows, g.conv_k + 1)
    assert torch.equal(got[:, : g.conv_k], patches)
    assert torch.equal(got[:, g.conv_k], torch.zeros(2 * g.P_rows))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int32, torch.uint8])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_max_pool2d_matches_jax(dtype, layout):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 200, size=(2, 7, 9, 3) if layout == "NHWC" else (2, 3, 7, 9))
    x = x.astype(np.float32 if dtype == torch.float32 else
                 (np.int32 if dtype == torch.int32 else np.uint8))
    for pool in (1, 2, 3):
        want = np.asarray(jcv.max_pool2d(jnp.asarray(x), pool, layout))
        got = tcv.max_pool2d(torch.from_numpy(x), pool, layout)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcv.max_pool2d(torch.from_numpy(x[0]), pool, layout).numpy(),
            np.asarray(jcv.max_pool2d(jnp.asarray(x[0]), pool, layout)))
    # maps with an axis shorter than the window give an empty map, 3-D and
    # 4-D: pool 2 on an empty axis, pool 3 on a 1-row axis
    for (h, w), pool in (((0, 5), 2), ((1, 5), 3), ((4, 1), 3), ((2, 0), 2)):
        shape = (2, h, w, 3) if layout == "NHWC" else (2, 3, h, w)
        e = np.zeros(shape, dtype=x.dtype)
        for arr in (e, e[0]):
            want = np.asarray(jcv.max_pool2d(jnp.asarray(arr), pool, layout))
            got = tcv.max_pool2d(torch.from_numpy(arr), pool, layout)
            assert got.dtype == dtype and 0 in got.shape
            assert tuple(got.shape) == want.shape


@pytest.mark.parametrize("engine", ["auto", "einsum", "kernel", "kernel_implicit",
                                    "pas_kernel", "pas_kernel_implicit", "pas_einsum"])
def test_conv2d_pool_longer_than_the_map_matches_jax(engine):
    """k 5x3, s 2, valid_centred on a 10x4 image: a 3x1 conv map, shorter
    than the pool-3 window on one axis, so the unfused max_pool2d returns an
    empty map.  Held against JAX's engine of the same name, which runs this
    shape (its kernel engines raise only on an empty conv output)."""
    rng = np.random.default_rng(11)
    idx = rng.integers(0, 16, size=(4, 2, 5, 3)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((1, 16)).astype(np.float32), axis=1)
    bias = rng.standard_normal(4).astype(np.float32)
    pj = jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(bias))
    pt = interop.conv_params_from_numpy(_conv_tree(pj), device="cpu")
    conv = dict(k=(5, 3), c_in=2, c_out=4, stride=2, padding="valid_centred",
                relu=True)
    x = rng.standard_normal((2, 2, 10, 4)).astype(np.float32)
    yt = tcv.conv2d(torch.from_numpy(x), pt, tcv.Conv2D(**conv), engine=engine, pool=3)
    yj = jcv.conv2d(jnp.asarray(x), pj, jcv.Conv2D(**conv), engine=engine, pool=3,
                    interpret=True)
    assert tuple(yt.shape) == np.asarray(yj).shape == (2, 4, 1, 0)


@pytest.mark.parametrize("engine", ["kernel_implicit", "pas_kernel_implicit"])
def test_conv2d_takes_more_than_65535_images(engine):
    """65536 images of 1x3x3: the implicit engines take any batch (K2's rows
    run over the batch, K4 splits one into launches of at most PAS_MAX_M
    rows), as JAX's do.  Held against JAX's einsum engine."""
    rng = np.random.default_rng(13)
    idx = rng.integers(0, 16, size=(4, 1, 3, 3)).astype(np.uint8)
    cb = np.sort(rng.standard_normal((1, 16)).astype(np.float32), axis=1)
    bias = rng.standard_normal(4).astype(np.float32)
    pj = jcv.ConvParams.shared(jnp.asarray(idx), jnp.asarray(cb), bias=jnp.asarray(bias))
    pt = interop.conv_params_from_numpy(_conv_tree(pj), device="cpu")
    conv = dict(k=3, c_in=1, c_out=4, relu=True)
    x = rng.standard_normal((65536, 1, 3, 3)).astype(np.float32)
    yt = tcv.conv2d(torch.from_numpy(x), pt, tcv.Conv2D(**conv), engine=engine)
    yj = jcv.conv2d(jnp.asarray(x), pj, jcv.Conv2D(**conv), engine="einsum")
    assert tuple(yt.shape) == (65536, 4, 1, 1)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **TOL)


def test_pool_plan_and_tiles():
    for pool in range(1, 20):
        assert tops.pool_plan_exists(pool) == jops.pool_plan_exists(pool)
        if tops.pool_plan_exists(pool):
            bm = tpm._pool_bm(pool)
            assert bm in tpm.BM_TILES and pool * pool <= bm
            assert bm == min(t for t in tpm.BM_TILES if pool * pool <= t)
        else:
            with pytest.raises(ValueError):
                tpm._pool_bm(pool)
            # the wrapper derives the tile from pool, so it refuses the window
            x = torch.zeros((pool * pool, 4))
            with pytest.raises(ValueError, match="unfused"):
                tpm.pasm_matmul_kernel_call(
                    x, torch.zeros((4, 2), dtype=torch.uint8),
                    torch.zeros((1, 2)), packed=False, pool=pool)


def _small_operands(requires_grad=False):
    x = torch.randn(8, 32, requires_grad=requires_grad)
    idx = torch.randint(0, 16, (16, 5), dtype=torch.uint8)
    cb = torch.randn(1, 16)
    return x, idx, cb


def test_wrappers_validate_and_run_plain_on_cpu():
    tpm.reset_launches()
    x, idx, cb = _small_operands()
    y = tpm.pasm_matmul_kernel_call(x, idx, cb, packed=True)
    want = tref.pasm_matmul_ref(x, idx, cb, packed=True)
    assert torch.equal(y, want)
    # plain path: no launch; one counter dict for all six kernels
    assert tpm.launches == {"pasm_matmul": 0, "pasm_conv": 0, "pas_matmul": 0,
                            "pas_conv": 0, "flash_attention": 0, "decode_attention": 0}
    with pytest.raises(RuntimeError, match="kernels.ops"):
        tpm.pasm_matmul_kernel_call(_small_operands(True)[0], idx, cb, packed=True)
    with torch.no_grad():  # inference on parameters is fine
        tpm.pasm_matmul_kernel_call(_small_operands(True)[0], idx, cb, packed=True)
    with pytest.raises(ValueError, match="gather"):
        tpm.pasm_matmul_kernel_call(x, idx, cb, packed=True, gather="scatter")
    for g in tpm.GATHERS:  # two TPU lowerings of one function
        assert torch.equal(tpm.pasm_matmul_kernel_call(x, idx, cb, packed=True, gather=g), y)
    with pytest.raises(ValueError, match="reduction rows"):
        tpm.pasm_matmul_kernel_call(x, idx, cb, packed=False)
    with pytest.raises(TypeError):
        tpm.pasm_matmul_kernel_call(x.double(), idx, cb, packed=True)
    with pytest.raises(ValueError, match="window-major"):
        tpm.pasm_matmul_kernel_call(x[:6], idx, cb, packed=True, pool=2)
    with pytest.raises(ValueError, match="device"):
        tpm.pasm_matmul_kernel_call(x.to("meta"), idx.to("meta"), cb.to("meta"),
                                    packed=True)
