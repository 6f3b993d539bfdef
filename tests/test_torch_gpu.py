"""K1–K5 on the card against their plain versions (``-m gpu``), and the
dense LM served on K1.

Every test here takes the ``cuda`` fixture, which skips when no card is
present; the decision is made when the test runs, never at import, so every
pytest worker collects the same tests.  Run on a card with::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import alexnet_conv
from repro_torch.core import conv as cv
from repro_torch.core import pasm as _pasm
from repro_torch.kernels import ops
from repro_torch.kernels import pas_histogram as ph
from repro_torch.kernels import pasm_matmul as pm
from repro_torch.models import cnn

pytestmark = pytest.mark.gpu
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 sums in another order


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _params(kshape, bins, groups, packed, layout, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    kernel = torch.randn(kshape, generator=g, device=dev) * 0.1
    bias = torch.randn(kshape[0], generator=g, device=dev)
    p = cv.ConvParams.quantize(kernel, bins, bias=bias, groups=groups, layout=layout)
    return p.pack(layout=layout) if packed else p


@pytest.mark.parametrize("M,K,N,bins,groups,packed,pool", [
    (64, 64, 64, 16, 1, True, 1),
    (100, 363, 96, 16, 1, False, 1),
    (36, 2400, 70, 16, 2, True, 3),
    (1024, 3456, 256, 16, 1, True, 2),
    (256, 40, 10, 256, 1, False, 16),   # a 256-row window: the 256-row tile
    (144 * 3, 64, 20, 16, 1, False, 12),  # 144-row windows: the 256-row tile
    (200, 300, 70, 16, 2, True, 1),       # two dictionaries, packed
    (64, 90, 40, 16, 2, True, 1),         # a packed byte across two dictionaries
    (70, 363, 10, 16, 1, False, 1),       # 4-byte x copies, N < 16: byte indices
])
def test_k1_matches_plain(cuda, M, K, N, bins, groups, packed, pool):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn((M, K), generator=g, device=cuda)
    # packed: any byte is two valid 4-bit indices
    idx = torch.randint(0, 256 if packed else bins, (K // 2 if packed else K, N),
                        generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((groups, bins), generator=g, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    before = pm.launches["pasm_matmul"]
    y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=packed, relu=True,
                                   pool=pool)
    assert pm.launches["pasm_matmul"] == before + 1
    want = pm.pasm_matmul_plain(x, idx, cb, bias, packed=packed, relu=True, pool=pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, **TOL)


@pytest.mark.parametrize("M,K,N,packed,pool", [
    (2592, 2304, 384, False, 1),   # conv3 at batch 32: 4 splits
    (1568, 3456, 384, False, 1),   # conv4: 6 splits
    (512, 3456, 256, True, 2),     # conv5: 6 splits
])
def test_k1_split_matches_plain(cuda, M, K, N, packed, pool):
    """AlexNet's split stages at batch 32, with dictionaries at a conv
    layer's scale (1/sqrt(K), as the served model's): at unit scale the
    outputs reach |y| ~ 60, and two f32 orders of 3456 terms differ by more
    than the absolute 1e-4 near 0."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn((M, K), generator=g, device=cuda)
    idx = torch.randint(0, 256 if packed else 16, (K // 2 if packed else K, N),
                        generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((1, 16), generator=g, device=cuda) * K ** -0.5
    bias = torch.randn(N, generator=g, device=cuda)
    assert pm.simt_plan(M, K, N, pool).splits > 1
    y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=packed, relu=True,
                                   pool=pool)
    want = pm.pasm_matmul_plain(x, idx, cb, bias, packed=packed, relu=True, pool=pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, **TOL)


@pytest.mark.parametrize("layout,padding,pool,packed,groups", [
    ("NCHW", "valid_centred", 2, False, 1),
    ("NHWC", "same", 2, True, 1),
    ("NCHW", "same", 1, True, 5),      # packed groups need even K/G: 150/5
    ("NHWC", "valid", 3, False, 3),
    ("NHWC", "valid_centred", 2, False, 2),
    ("NCHW", "same", 2, True, 1),
])
def test_k2_matches_plain_and_k1_bitwise(cuda, layout, padding, pool, packed, groups):
    conv = cv.Conv2D(k=5, c_in=6, c_out=70, stride=2, padding=padding,
                     layout=layout, relu=True)
    p = _params((70, 6, 5, 5), 16, groups, packed, layout, cuda)
    shape = (3, 37, 33, 6) if layout == "NHWC" else (3, 6, 37, 33)
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    g = cv.conv_geom(conv, 37, 33, pool=pool)
    t = p.gemm_tensor(layout)
    before = pm.launches["pasm_conv"]
    y2 = ops.pasm_conv2d(x, t, g, bias=p.bias, relu=True)
    assert pm.launches["pasm_conv"] == before + 1
    want = pm.pasm_conv_plain(x, t.idx, t.codebook, p.bias, geom=g,
                              packed=t.packed, relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, want, **TOL)
    # K1 over the explicit window-major patches walks the same products, and
    # the fused pool equals the kernel without pool followed by max_pool2d
    y1 = cv.conv2d(x, p, conv, engine="kernel", pool=pool)
    y2c = cv.conv2d(x, p, conv, engine="kernel_implicit", pool=pool)
    assert torch.equal(y1, y2c)
    for engine in ("kernel", "kernel_implicit"):
        unfused = cv.conv2d(x, p, conv, engine=engine, pool=pool, pool_impl="unfused")
        assert torch.equal(unfused, y1)


@pytest.mark.parametrize("c_in,c_out,hw,pool", [(384, 384, 9, 1), (384, 256, 7, 2)],
                         ids=["conv4", "conv5"])
def test_k2_split_matches_plain_and_k1_bitwise(cuda, c_in, c_out, hw, pool):
    """AlexNet's conv4 and conv5 at batch 32: the plan splits K; K1 over the
    window-major patches still equals K2, and the fused pool the unfused."""
    conv = cv.Conv2D(k=3, c_in=c_in, c_out=c_out, padding="valid_centred", relu=True)
    p = _params((c_out, c_in, 3, 3), 16, 1, False, "NCHW", cuda)
    x = torch.randn((32, c_in, hw, hw),
                    generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    g = cv.conv_geom(conv, hw, hw, pool=pool)
    assert pm.simt_plan(32 * g.P_rows, g.conv_k, c_out, pool).splits > 1
    t = p.gemm_tensor("NCHW")
    y2 = ops.pasm_conv2d(x, t, g, bias=p.bias, relu=True)
    want = pm.pasm_conv_plain(x, t.idx, t.codebook, p.bias, geom=g, packed=False,
                              relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, want, **TOL)
    y1 = cv.conv2d(x, p, conv, engine="kernel", pool=pool)
    assert torch.equal(cv.conv2d(x, p, conv, engine="kernel_implicit", pool=pool), y1)
    unfused = cv.conv2d(x, p, conv, engine="kernel_implicit", pool=pool,
                        pool_impl="unfused")
    assert torch.equal(unfused, y1)


@pytest.mark.parametrize("pool", [1, 2])
def test_k2_rows_cross_images(cuda, pool):
    """16 GEMM rows an image (4x4 maps), 20 images: a 128-row block holds
    rows of 8 images, and K2 equals its plain version and K1 bitwise."""
    conv = cv.Conv2D(k=3, c_in=8, c_out=40, padding="valid", relu=True)
    p = _params((40, 8, 3, 3), 16, 1, True, "NCHW", cuda)
    x = torch.randn((20, 8, 6, 6), generator=torch.Generator(device=cuda).manual_seed(6),
                    device=cuda)
    g = cv.conv_geom(conv, 6, 6, pool=pool)
    assert g.P_rows == 16
    t = p.gemm_tensor("NCHW")
    y2 = ops.pasm_conv2d(x, t, g, bias=p.bias, relu=True)
    want = pm.pasm_conv_plain(x, t.idx, t.codebook, p.bias, geom=g, packed=True,
                              relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, want, **TOL)
    assert torch.equal(cv.conv2d(x, p, conv, engine="kernel", pool=pool),
                       cv.conv2d(x, p, conv, engine="kernel_implicit", pool=pool))


@pytest.mark.parametrize("M,K,N,pool", [
    (512, 3456, 256, 2),     # conv5 at batch 32: split-K
    (2592, 2304, 384, 1),    # conv3 at batch 32: split-K
    (9 * 60, 300, 21, 3),
    (144 * 4, 64, 20, 12),
])
def test_k1_simt_rows_do_not_depend_on_m(cuda, M, K, N, pool):
    """A slice of whole pool windows, wherever it starts, gives the rows of
    the full call bitwise: the split-K partition and the order of every sum
    are set by K and N, never by M or by where a block's tile falls."""
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn((M, K), generator=g, device=cuda)
    idx = torch.randint(0, 16, (K, N), generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((1, 16), generator=g, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=False, relu=True, pool=pool)
    pw = pool * pool
    for w0, nw in ((0, 1), (1, 3), (5, M // pw // 2), (M // pw - 2, 2)):
        part = pm.pasm_matmul_kernel_call(x[w0 * pw:(w0 + nw) * pw].contiguous(),
                                          idx, cb, bias, packed=False, relu=True,
                                          pool=pool)
        torch.cuda.synchronize()
        assert torch.equal(part, y[w0:w0 + nw]), (w0, nw)


def test_implicit_convs_take_70000_images(cuda, monkeypatch):
    """More images than a grid's y/z extent: K2 runs its rows over the batch,
    K4 too and splits a batch of more than PAS_MAX_M rows into launches of
    whole images, which give the same rows bitwise."""
    conv = cv.Conv2D(k=3, c_in=1, c_out=8, relu=True)
    p = _params((8, 1, 3, 3), 16, 1, False, "NCHW", cuda)
    x = torch.randn((70000, 1, 3, 3), generator=torch.Generator(device=cuda).manual_seed(3),
                    device=cuda)
    g = cv.conv_geom(conv, 3, 3)
    t = p.gemm_tensor("NCHW")
    y2 = ops.pasm_conv2d(x, t, g, bias=p.bias, relu=True)
    want = pm.pasm_conv_plain(x, t.idx, t.codebook, p.bias, geom=g, packed=False,
                              relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y2, want, **TOL)
    assert torch.equal(cv.conv2d(x, p, conv, engine="kernel"),
                       cv.conv2d(x, p, conv, engine="kernel_implicit"))
    li = _pasm.logical_idx(t)
    pm.reset_launches()
    y4 = ops.pas_conv2d(x, t, g, bias=p.bias, relu=True)
    assert pm.launches["pas_conv"] == 1
    torch.testing.assert_close(y4, ph.pas_conv_plain(x, li, t.codebook, p.bias, geom=g,
                                                     relu=True), **TOL)
    monkeypatch.setattr(ph, "PAS_MAX_M", 30000)
    pm.reset_launches()
    assert torch.equal(ops.pas_conv2d(x, t, g, bias=p.bias, relu=True), y4)
    assert pm.launches["pas_conv"] == 3


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_implicit_convs_take_an_image_past_16_bit_coordinates(cuda, layout):
    """A 3 x 40000 map (W > 32767; NHWC: H): K4 takes its wide row record,
    and K3 over the explicit patches still equals it bitwise; K2 too."""
    conv = cv.Conv2D(k=3, c_in=2, c_out=8, padding="same", layout=layout, relu=True)
    p = _params((8, 2, 3, 3), 16, 1, False, layout, cuda)
    hw = (3, 40000) if layout == "NCHW" else (40000, 3)
    shape = (1, 2) + hw if layout == "NCHW" else (1,) + hw + (2,)
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(2), device=cuda)
    g = cv.conv_geom(conv, *hw)
    t = p.gemm_tensor(layout)
    y4 = ops.pas_conv2d(x, t, g, bias=p.bias, relu=True)
    want = ph.pas_conv_plain(x, _pasm.logical_idx(t), t.codebook, p.bias, geom=g,
                             relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y4, want, **TOL)
    assert torch.equal(cv.conv2d(x, p, conv, engine="pas_kernel"),
                       cv.conv2d(x, p, conv, engine="pas_kernel_implicit"))
    y2 = ops.pasm_conv2d(x, t, g, bias=p.bias, relu=True)
    torch.testing.assert_close(y2, pm.pasm_conv_plain(x, t.idx, t.codebook, p.bias,
                                                      geom=g, packed=False, relu=True),
                               **TOL)
    assert torch.equal(cv.conv2d(x, p, conv, engine="kernel"),
                       cv.conv2d(x, p, conv, engine="kernel_implicit"))


def test_smoke_forward_on_the_card(cuda):
    cfg = alexnet_conv.smoke_config()
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = cnn.quantize(cnn.init_params(cfg, gen, device=cuda), cfg)
    x = torch.randn((4, 3, 32, 32), generator=gen, device=cuda)
    want = cnn.forward(q, x, dataclasses.replace(cfg, impl="einsum"))
    keys = {"kernel": "pasm_matmul", "kernel_implicit": "pasm_conv",
            "pas_kernel": "pas_matmul"}
    for impl, key in keys.items():
        pm.reset_launches()
        got = cnn.forward(q, x, dataclasses.replace(cfg, impl=impl))
        assert pm.launches == {k: len(cfg.layers) if k == key else 0
                               for k in pm.launches}
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert np.isfinite(got.cpu().numpy()).all()


def test_kernels_raise_on_grad(cuda):
    x = torch.randn((8, 16), device=cuda, requires_grad=True)
    idx = torch.zeros((16, 4), dtype=torch.uint8, device=cuda)
    cb = torch.zeros((1, 4), device=cuda)
    with pytest.raises(RuntimeError, match="kernels.ops"):
        pm.pasm_matmul_kernel_call(x, idx, cb, packed=False)


# ---------------------------------------------------------------------------
# K3 / K4: the paper-faithful two-phase PAS kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M,K,N,bins,packed,pool", [
    (64, 364, 96, 16, True, 2),     # conv1's K with its pad row, packed
    (100, 200, 70, 4, False, 1),    # ragged M and N, one 4-bin pass
    (36, 2400, 40, 16, False, 3),
    (64, 96, 33, 256, False, 2),    # 16 passes of 16 bins
    (144, 40, 10, 16, True, 6),     # a 144-row window: the 256-row tile
    (4 * 97, 37, 17, 16, False, 2),  # M, N and K off the tile and the stage
    (200, 150, 24, 1, False, 1),    # one bin
    (130, 77, 20, 5, False, 1),     # a partial pass of 5
    (290, 61, 18, 20, False, 1),    # a full pass and a partial one
    (36 * 5, 120, 17, 256, False, 3),
    (9 * 30, 300, 21, 16, False, 3),   # 9-row windows across lanes
    (36 * 8, 100, 20, 16, False, 6),   # 36-row windows across lanes
    (144 * 3, 64, 20, 16, False, 12),  # 2 x 4 warps: 256 x 8 outputs
    (512, 3456, 256, 16, False, 2),    # conv5 at batch 32, split-K
])
def test_k3_matches_plain(cuda, M, K, N, bins, packed, pool):
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn((M, K), generator=g, device=cuda)
    idx = torch.randint(0, bins, (K, N), generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((1, bins), generator=g, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    t = _pasm.PASMTensor(idx=_pasm.pack_int4(idx) if packed else idx, codebook=cb,
                         shape=(K, N), bins=bins, bits=4 if packed else 8,
                         packed=packed)
    before = pm.launches["pas_matmul"]
    y = ops.pas_matmul(x, t, bias=bias, relu=True, pool=pool)
    assert pm.launches["pas_matmul"] == before + 1
    want = ph.pas_matmul_plain(x, idx, cb, bias, relu=True, pool=pool)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, **TOL)


@pytest.mark.parametrize("layout,padding,pool,packed,bins", [
    ("NCHW", "valid_centred", 2, False, 16),
    ("NHWC", "same", 2, True, 16),
    ("NCHW", "same", 1, True, 4),
    ("NHWC", "valid", 3, False, 256),
    ("NCHW", "same", 2, False, 2),
    ("NCHW", "valid", 3, True, 5),
    ("NHWC", "same", 6, False, 20),
])
def test_k4_matches_plain_and_k3_bitwise(cuda, layout, padding, pool, packed, bins):
    conv = cv.Conv2D(k=5, c_in=6, c_out=70, stride=2, padding=padding,
                     layout=layout, relu=True)
    p = _params((70, 6, 5, 5), bins, 1, packed, layout, cuda)
    shape = (3, 37, 33, 6) if layout == "NHWC" else (3, 6, 37, 33)
    x = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda)
    g = cv.conv_geom(conv, 37, 33, pool=pool)
    t = p.gemm_tensor(layout)
    before = pm.launches["pas_conv"]
    y4 = ops.pas_conv2d(x, t, g, bias=p.bias, relu=True)
    assert pm.launches["pas_conv"] == before + 1
    want = ph.pas_conv_plain(x, _pasm.logical_idx(t), t.codebook, p.bias, geom=g,
                             relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y4, want, **TOL)
    # K3 over the window-major patches adds into the same bins in the same
    # order; the fused pool equals the kernel without pool + max_pool2d
    y3 = cv.conv2d(x, p, conv, engine="pas_kernel", pool=pool)
    assert torch.equal(cv.conv2d(x, p, conv, engine="pas_kernel_implicit", pool=pool), y3)
    for engine in ("pas_kernel", "pas_kernel_implicit"):
        unfused = cv.conv2d(x, p, conv, engine=engine, pool=pool, pool_impl="unfused")
        assert torch.equal(unfused, y3)


def test_k4_split_matches_plain_and_k3_bitwise(cuda):
    """conv5's shape (384 -> 256 channels, 3x3 over 7x7, pool 2): the plan
    splits K, and K3 over the window-major patches still equals K4."""
    conv = cv.Conv2D(k=3, c_in=384, c_out=256, padding="valid_centred",
                     relu=True)
    p = _params((256, 384, 3, 3), 16, 1, False, "NCHW", cuda)
    x = torch.randn((3, 384, 7, 7), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    g = cv.conv_geom(conv, 7, 7, pool=2)
    assert ph.pas_plan(3 * g.P_rows, g.conv_k, 256, 16, 2).splits > 1
    t = p.gemm_tensor("NCHW")
    y4 = ops.pas_conv2d(x, t, g, bias=p.bias, relu=True)
    want = ph.pas_conv_plain(x, _pasm.logical_idx(t), t.codebook, p.bias, geom=g,
                             relu=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y4, want, **TOL)
    y3 = cv.conv2d(x, p, conv, engine="pas_kernel", pool=2)
    assert torch.equal(cv.conv2d(x, p, conv, engine="pas_kernel_implicit", pool=2), y3)
    unfused = cv.conv2d(x, p, conv, engine="pas_kernel_implicit", pool=2,
                        pool_impl="unfused")
    assert torch.equal(unfused, y3)


@pytest.mark.parametrize("M,K,N,bins,pool", [
    (512, 3456, 256, 16, 2),     # conv5 at batch 32: split-K
    (2592, 2304, 384, 16, 1),    # conv3 at batch 32
    (9 * 60, 300, 21, 20, 3),
    (144 * 4, 64, 20, 16, 12),
])
def test_k3_rows_do_not_depend_on_m(cuda, M, K, N, bins, pool):
    """A slice of whole pool windows, wherever it starts, gives the rows of
    the full call bitwise: the split-K partition and the order of every sum
    are set by K and N, never by M or by where a block's tile falls."""
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((M, K), generator=g, device=cuda)
    idx = torch.randint(0, bins, (K, N), generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((1, bins), generator=g, device=cuda)
    bias = torch.randn(N, generator=g, device=cuda)
    y = ph.pas_matmul_kernel_call(x, idx, cb, bias, relu=True, pool=pool)
    pw = pool * pool
    for w0, nw in ((0, 1), (1, 3), (5, M // pw // 2), (M // pw - 2, 2)):
        part = ph.pas_matmul_kernel_call(x[w0 * pw:(w0 + nw) * pw].contiguous(),
                                         idx, cb, bias, relu=True, pool=pool)
        torch.cuda.synchronize()
        assert torch.equal(part, y[w0:w0 + nw]), (w0, nw)


def test_k3_equals_k1_on_integers(cuda):
    """Paper §5.3: in integer arithmetic PASM is bit-exact vs the
    weight-shared MAC.  |sums| < 2^24, so f32 holds them exactly."""
    g = torch.Generator(device=cuda).manual_seed(5)
    M, K, N = 256, 2400, 96
    x = torch.randint(-8, 9, (M, K), generator=g, device=cuda).float()
    idx = torch.randint(0, 16, (K, N), generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randint(-8, 9, (1, 16), generator=g, device=cuda).float()
    bias = torch.randint(-99, 99, (N,), generator=g, device=cuda).float()
    y3 = ph.pas_matmul_kernel_call(x, idx, cb, bias, relu=True, pool=2)
    y1 = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=False, relu=True, pool=2)
    assert torch.equal(y3, y1)


def test_pas_kernels_drop_out_of_range_indices(cuda):
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((64, 80), generator=g, device=cuda)
    idx = torch.randint(0, 24, (80, 40), generator=g, device=cuda, dtype=torch.uint8)
    cb = torch.randn((1, 16), generator=g, device=cuda)
    y = ph.pas_matmul_kernel_call(x, idx, cb)
    w = torch.where(idx < 16, cb[0][idx.long().clamp(max=15)], 0.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, x @ w, **TOL)
    torch.testing.assert_close(y, ph.pas_matmul_plain(x, idx, cb), **TOL)
    conv = cv.Conv2D(k=1, c_in=80, c_out=40)
    geom = cv.conv_geom(conv, 8, 8)
    img = x.reshape(1, 8, 8, 80).permute(0, 3, 1, 2).contiguous()
    y4 = ph.pas_conv_kernel_call(img, idx, cb, geom=geom)
    torch.cuda.synchronize()
    assert torch.equal(y4.reshape(64, 40), y)


def test_pas_kernels_raise_on_grad(cuda):
    x = torch.randn((8, 16), device=cuda, requires_grad=True)
    idx = torch.zeros((16, 4), dtype=torch.uint8, device=cuda)
    cb = torch.zeros((1, 4), device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        ph.pas_matmul_kernel_call(x, idx, cb)
    conv = cv.Conv2D(k=1, c_in=16, c_out=4)
    img = torch.randn((1, 16, 2, 4), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ph.pas_conv_kernel_call(img, idx, cb, geom=cv.conv_geom(conv, 2, 4))


# ---------------------------------------------------------------------------
# K5: flash attention; K1 with bf16 activations; the LM on the card
# ---------------------------------------------------------------------------


def _assert_k5_close(y, q, k, v, *, causal, sk_orig):
    """K5 against flash_attention_plain.  f32: sums in another order (1e-5).
    bf16: the tensor-core route rounds P to bf16 before P·V (the JAX kernel
    keeps it f32), 2^-9·Σ_j p_j·|v_j| at most, and both round the output to
    bf16, so |Δ| <= 2^-7·(|plain| + Σ_j p_j·|v_j|) (``fa.BF16_TOL``); the
    sum is the plain version on |v| (p >= 0), and scales with the values P
    weighs, not with |o|, which can cancel."""
    from repro_torch.kernels import flash_attention as fa

    want = fa.flash_attention_plain(q, k, v, causal=causal, sk_orig=sk_orig)
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        return
    pv = fa.flash_attention_plain(q, k, v.abs(), causal=causal, sk_orig=sk_orig)
    d = (y.float() - want.float()).abs()
    lim = fa.BF16_TOL * (want.float().abs() + pv.float())
    assert bool(torch.isfinite(y.float()).all()) and bool((d <= lim).all()), \
        f"max |Δ| {float(d.max()):.3e}, {int((d > lim).sum())} over tolerance"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("BKV,G,Sq,Sk,kvalid,hd", [
    (4, 2, 64, 64, 64, 16),
    (1, 4, 56, 56, 56, 16),      # ragged S
    (1, 8, 128, 128, 128, 32),   # MQA
    (2, 1, 100, 100, 100, 80),   # stablelm's hd, not a power of two
    (1, 8, 130, 130, 120, 128),  # pad keys masked past kvalid
    (1, 2, 70, 70, 70, 64),
    (1, 2, 65, 65, 65, 192),
    (1, 2, 40, 40, 40, 256),
])
def test_k5_matches_plain(cuda, dtype, causal, BKV, G, Sq, Sk, kvalid, hd):
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(hd + Sq)
    q = torch.randn((BKV, G, Sq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((BKV, Sk, hd), generator=g, device=cuda).to(dtype)
    v = torch.randn((BKV, Sk, hd), generator=g, device=cuda).to(dtype)
    before = pm.launches["flash_attention"]
    y = fa.flash_attention_kernel_call(q, k, v, causal=causal, sk_orig=kvalid)
    assert pm.launches["flash_attention"] == before + 1 and y.dtype == dtype
    _assert_k5_close(y, q, k, v, causal=causal, sk_orig=kvalid)


def test_k5_through_ops_matches_gqa_attention(cuda):
    from repro_torch.nn import attention as A

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((2, 300, 8, 64), generator=g, device=cuda)
    k = torch.randn((2, 300, 2, 64), generator=g, device=cuda)
    v = torch.randn((2, 300, 2, 64), generator=g, device=cuda)
    y = ops.flash_attention(q, k, v, causal=True)
    want = A.gqa_attention(q, k, v, causal=True, chunk=128)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :48], k[..., :48], v[..., :48])


@pytest.mark.parametrize("M,K,N,groups", [(4, 512, 192, 1), (33, 1000, 70, 2)])
def test_k1_bf16_matches_plain_and_dequant(cuda, M, K, N, groups):
    from repro_torch.core import params as P

    g = torch.Generator(device=cuda).manual_seed(M)
    w = torch.randn((K, N), generator=g, device=cuda) * 0.05
    x = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    p = P.PasmParams.quantize(w, 16, groups=groups).pack()
    t = p.gemm_tensor()
    y = pm.pasm_matmul_kernel_call(x, t.idx, t.codebook, packed=True)
    want = pm.pasm_matmul_plain(x, t.idx, t.codebook, packed=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, want, **TOL)
    yk = P.matmul(x, p, impl="kernel")
    yd = P.matmul(x, p, impl="dequant")
    assert yk.dtype == yd.dtype == torch.bfloat16
    torch.testing.assert_close(yk.float(), yd.float(), rtol=2.0 ** -7, atol=1e-5)


def test_lm_serves_on_the_card(cuda):
    """The qwen3 smoke config served on K1: launches per model call, no
    degradation, tokens equal to the dequant oracle's."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params
    from repro_torch.serve.engine import Engine

    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    params = quantize_params(TT.init_params(cfg, torch.Generator(device=cuda).manual_seed(0)), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 11, 3)]
    outs = {}
    for impl in ("kernel", "dequant"):
        eng = Engine(cfg.with_quant(impl=impl), params, batch_slots=2, max_seq=32)
        pm.reset_launches()
        reqs = [eng.submit(p, max_new=6) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        per_call = 7 * cfg.n_layers + 1
        n_calls = eng.calls["prefill"] + eng.calls["decode"]
        assert pm.launches["pasm_matmul"] == (per_call * n_calls if impl == "kernel" else 0)
        assert eng.metrics.rollup().get("n_degraded", 0) == 0
        outs[impl] = [r.out for r in reqs]
    agree = np.mean([a == b for x, y in zip(outs["kernel"], outs["dequant"])
                     for a, b in zip(x, y)])
    assert agree >= 0.9


# ---------------------------------------------------------------------------
# K5's bf16 tensor-core route; K1's bf16 routes (stream, mma)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128, 192, 256])
@pytest.mark.parametrize("BKV,G,Sq,Sk,kvalid", [
    (2, 4, 96, 96, 96),      # GQA
    (3, 1, 70, 130, 130),    # MHA, Sq != Sk, both ragged
    (1, 8, 129, 65, 50),     # MQA-like wide group, keys past sk_orig masked
    (1, 2, 1, 200, 200),     # a single query row
])
def test_k5_bf16_tensor_core_matches_plain(cuda, hd, causal, BKV, G, Sq, Sk, kvalid):
    from repro_torch.kernels import flash_attention as fa

    rng = np.random.default_rng(hd * 1000 + Sq + Sk)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(cuda).bfloat16() for s in ((BKV, G, Sq, hd), (BKV, Sk, hd),
                                              (BKV, Sk, hd)))
    before = pm.launches["flash_attention"]
    y = fa.flash_attention_kernel_call(q, k, v, causal=causal, sk_orig=kvalid)
    assert pm.launches["flash_attention"] == before + 1 and y.dtype == torch.bfloat16
    _assert_k5_close(y, q, k, v, causal=causal, sk_orig=kvalid)
    again = fa.flash_attention_kernel_call(q, k, v, causal=causal, sk_orig=kvalid)
    assert torch.equal(again, y)


def _k1_operands(dev, M, K, N, groups, packed, bins=16, seed=0):
    rng = np.random.default_rng(seed + M * 7 + K + N)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev).bfloat16()
    rows = K // 2 if packed else K
    idx = torch.from_numpy(rng.integers(0, 256 if packed else bins, (rows, N))
                           .astype(np.uint8)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((groups, bins)).astype(np.float32) * 0.1).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    return x, idx, cb, bias


def _assert_k1_bf16_close(y, x, idx, cb, bias, packed, relu):
    """|Δ| <= t·(|x|@|W|) + 1e-6: the same exact products summed in another
    order (tensor-core accumulation on mma); |x|@|W| bounds the sum's
    rounding where the output itself cancels."""
    want = pm.pasm_matmul_plain(x, idx, cb, bias, packed=packed, relu=relu)
    scale = pm.pasm_matmul_plain(x.abs(), idx, cb.abs(), packed=packed)
    torch.cuda.synchronize()
    d = (y - want).abs()
    assert bool(torch.isfinite(y).all())
    assert bool((d <= pm.K1_BF16_TOL * scale + 1e-6).all()), float(d.max())


@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 384])
@pytest.mark.parametrize("K,N,groups,packed", [
    (1000, 333, 2, True),    # K not a multiple of any tile, odd N, G = 2
    (512, 256, 1, False),    # uint8 indices
    (96, 130, 1, True),
    (998, 200, 2, False),    # uint8, G = 2, K / G odd
])
def test_k1_bf16_routes_match_plain(cuda, M, K, N, groups, packed):
    """stream up to STREAM_MAX_M rows (1, 4, 16), mma above (17, 64, 384)."""
    route = "stream" if M <= pm.STREAM_MAX_M else "mma"
    x, idx, cb, bias = _k1_operands(cuda, M, K, N, groups, packed)
    before = dict(pm.k1_routes)
    y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=packed, relu=True)
    assert pm.k1_routes[route] == before[route] + 1 and y.shape == (M, N)
    _assert_k1_bf16_close(y, x, idx, cb, bias, packed, True)
    # bitwise repeatable: split-K partials are added in a fixed order
    y2 = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=packed, relu=True)
    assert torch.equal(y, y2)


@pytest.mark.parametrize("M", [4, 384], ids=["stream", "mma"])
@pytest.mark.parametrize("K,N,groups,packed", [
    (8192, 640, 1, True),    # qwen3's wo rows, packed
    (3072, 512, 2, True),    # two dictionaries: a rank's block takes its own
    (2048, 384, 1, False),   # uint8 indices
])
def test_k1_row_parallel_block_matches_plain(cuda, M, K, N, groups, packed):
    """K1 on a row-parallel K block over ``model`` 2, as
    ``params.block_matmul`` launches it for ``params.tp_linear``: each rank's
    f32 partial against the plain version's partial on the same block (its
    own dictionaries), within ``K1_BF16_TOL·(|x|@|W|)``; the two partials
    sum to the unsharded plain call within twice that; an N block is
    bitwise the unsharded kernel call's columns (planned from the whole)."""
    from repro_torch.core import params as par
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh

    x, idx, cb, _ = _k1_operands(cuda, M, K, N, groups, packed)
    w = par.PasmParams(idx=idx, codebook=cb, kind="packed" if packed else "shared",
                       shape=(K, N), bins=16)
    whole = pm.pasm_matmul_kernel_call(x, idx, cb, packed=packed)
    ys, scale_sum, cols = [], 0, []
    for m in range(2):
        mesh = Mesh((1, 2), ("data", "model"), (0, m), (None, None), cuda)
        placed = sh.place_params({"w2": w, "w1": w}, mesh)
        before = pm.launches["pasm_matmul"]
        y, split = par.block_matmul(x, placed["w2"], impl="kernel", mesh=mesh, rows=M)
        assert split and pm.launches["pasm_matmul"] == before + 1
        pb, _ = par.held_block(placed["w2"], mesh)
        xb = x[:, m * K // 2:(m + 1) * K // 2].contiguous()
        want = pm.pasm_matmul_plain(xb, pb.idx, pb.codebook, packed=packed)
        scale = pm.pasm_matmul_plain(xb.abs(), pb.idx, pb.codebook.abs(), packed=packed)
        torch.cuda.synchronize()
        assert bool(((y - want).abs() <= pm.K1_BF16_TOL * scale + 1e-6).all())
        ys.append(y)
        scale_sum = scale_sum + scale
        c, col_split = par.block_matmul(x, placed["w1"], impl="kernel", mesh=mesh, rows=M)
        assert not col_split
        cols.append(c)
    plain = pm.pasm_matmul_plain(x, idx, cb, packed=packed)
    torch.cuda.synchronize()
    assert bool(((ys[0] + ys[1] - plain).abs() <= 2 * pm.K1_BF16_TOL * scale_sum + 1e-6).all())
    assert torch.equal(torch.cat(cols, -1), whole)


@pytest.mark.parametrize("M,rows", [(4, 1), (4 * (pm.STREAM_MAX_M + 1), pm.STREAM_MAX_M + 1)],
                         ids=["stream", "mma"])
@pytest.mark.parametrize("K,N,packed", [(5120, 1000, True), (25600, 512, True),
                                        (300, 77, False)])
def test_k1_bf16_rows_do_not_depend_on_m(cuda, M, rows, K, N, packed):
    """A row computed in a batch equals that row computed in a smaller one
    on the same route, bitwise (the Engine grafts batch-of-one prefills into
    batched state): stream at 4 rows against 1, mma at 68 against 17."""
    route = pm.k1_plan(rows, K, N, torch.bfloat16, packed=packed).route
    assert route == pm.k1_plan(M, K, N, torch.bfloat16, packed=packed).route
    x, idx, cb, bias = _k1_operands(cuda, M, K, N, 1, packed, seed=3)
    pm.reset_launches()
    y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=packed)
    for i in range(0, M, rows):
        part = pm.pasm_matmul_kernel_call(x[i:i + rows].contiguous(), idx, cb,
                                          bias, packed=packed)
        assert torch.equal(part, y[i:i + rows]), i
    assert pm.k1_routes[route] == 1 + M // rows


def test_k1_routes_by_plan(cuda):
    """bf16 takes stream up to M0 and mma above; f32 and pooled bf16 take the
    SIMT kernel, whose f32 result K2 matches bitwise (test_k2_...)."""
    K, N = 512, 192
    for M, dtype, pool, route in ((pm.STREAM_MAX_M, torch.bfloat16, 1, "stream"),
                                  (pm.STREAM_MAX_M + 1, torch.bfloat16, 1, "mma"),
                                  (64, torch.float32, 1, "simt"),
                                  (36, torch.bfloat16, 3, "simt")):
        x, idx, cb, bias = _k1_operands(cuda, M, K, N, 1, True)
        pm.reset_launches()
        pm.pasm_matmul_kernel_call(x.to(dtype), idx, cb, bias, packed=True, pool=pool)
        assert pm.k1_routes == {r: int(r == route) for r in pm.K1_ROUTES}
        assert pm.launches["pasm_matmul"] == 1
    # more dictionaries than the bf16 routes' tables hold, or a packed
    # byte's two rows in two dictionaries (K / G = 45): the SIMT kernel on
    # the widened x, equal to the f32 call bitwise
    for K, groups in ((512, 4), (90, 2)):
        x, idx, cb, bias = _k1_operands(cuda, 4, K, N, groups, True)
        pm.reset_launches()
        y = pm.pasm_matmul_kernel_call(x, idx, cb, bias, packed=True)
        assert pm.k1_routes == {"simt": 1, "stream": 0, "mma": 0}
        want = pm.pasm_matmul_kernel_call(x.float(), idx, cb.bfloat16().float(),
                                          bias, packed=True)
        assert torch.equal(y, want)
    # f16 takes the SIMT kernel on its exact widening, the codebook rounded
    # to f16 (JAX's kernels take f16 too); other dtypes raise
    pm.reset_launches()
    y = pm.pasm_matmul_kernel_call(x.half(), idx, cb, bias, packed=True)
    assert pm.k1_routes == {"simt": 1, "stream": 0, "mma": 0}
    assert torch.equal(y, pm.pasm_matmul_kernel_call(
        x.half().float(), idx, cb.half().float(), bias, packed=True))
    with pytest.raises(TypeError, match="float32"):
        pm.pasm_matmul_kernel_call(x.double(), idx, cb, packed=True)


# ---------------------------------------------------------------------------
# the K1/K2 autograd Functions on the card, and a bitwise-repeatable step
# ---------------------------------------------------------------------------

# |Δ| <= t·max|chain| per gradient: f32 sums in another order; bf16 x: dx
# rounded to bf16 on both sides, g to bf16 first on the Function's (the JAX
# VJP's rule), and the chain's codebook gradient comes back through its own
# bf16 rounding of the codebook
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
KINK = 1e-3


def _kink_free(pre, pool, gen):
    """A random upstream gradient over ``pre``'s window-major pooled rows,
    zero where the two sides may take different valid subgradients (the
    ReLU's kink, near-tied pool windows)."""
    pw = pool * pool
    win = pre.reshape(pre.shape[0] // pw, pw, pre.shape[1])
    top = torch.topk(win, min(2, pw), dim=1).values
    keep = top[:, 0].abs() >= KINK
    if pw > 1:
        keep &= (top[:, 0] - top[:, 1]) >= KINK
    return torch.randn(keep.shape, generator=gen, device=pre.device) * keep


def _assert_bwd_close(got, want, dtype, what):
    for a, w, n in zip(got, want, ("x", "codebook", "bias")):
        assert a.dtype == w.dtype and a.shape == w.shape, (what, n)
        top = float(w.float().abs().max())
        d = float((a.float() - w.float()).abs().max())
        assert d <= BWD_TOL[dtype] * top, f"{what} d{n}: |Δ| {d:.3e}, max {top:.3e}"


@pytest.mark.parametrize("M,K,N,bins,groups,packed,relu,pool,dtype", [
    (64, 363, 96, 16, 1, False, True, 2, torch.float32),   # conv1-like, pooled
    (64, 364, 96, 16, 1, True, True, 2, torch.float32),    # packed, pad row
    (200, 2304, 384, 16, 2, False, True, 1, torch.float32),  # grouped, split-K
    (144, 2400, 70, 16, 2, True, False, 3, torch.float32),
    (1024, 2048, 512, 16, 1, True, False, 1, torch.bfloat16),  # mma
    (8, 1024, 256, 16, 2, True, False, 1, torch.bfloat16),     # stream
])
def test_k1_backward_matches_chain(cuda, M, K, N, bins, groups, packed, relu, pool,
                                   dtype):
    g = torch.Generator(device=cuda).manual_seed(M + K + N)
    w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
    t = _pasm.quantize(w, bins, groups=groups, pack=packed)
    x0 = torch.randn((M, K), generator=g, device=cuda).to(dtype)
    b0 = torch.randn(N, generator=g, device=cuda) * 0.1 if relu or pool > 1 else None
    with torch.no_grad():
        pre = pm.pasm_matmul_plain(x0, t.idx, t.codebook, b0, packed=packed)
    up = _kink_free(pre if relu else pre + 10.0, pool, g)  # no ReLU: no kink
    grads = []
    for side in ("kernel", "chain"):
        x = x0.clone().requires_grad_()
        cb = t.codebook.clone().requires_grad_()
        b = None if b0 is None else b0.clone().requires_grad_()
        before = pm.launches["pasm_matmul"]
        if side == "kernel":
            y = ops.pasm_matmul(x, dataclasses.replace(t, codebook=cb), bias=b,
                                relu=relu, pool=pool)
            assert pm.launches["pasm_matmul"] == before + 1
        else:
            y = pm.pasm_matmul_plain(x, t.idx, cb, b, packed=packed, relu=relu,
                                     pool=pool)
        grads.append(torch.autograd.grad(y, [x, cb] + ([] if b is None else [b]), up))
    torch.cuda.synchronize()
    _assert_bwd_close(grads[0], grads[1], dtype, f"K1 M{M} K{K} N{N}")


@pytest.mark.parametrize("M", [8, 1024], ids=["stream", "mma"])
@pytest.mark.parametrize("name", ["w2", "w1"], ids=["k_block", "n_block"])
def test_k1_block_backward_matches_chain(cuda, M, name):
    """``_PasmMatmul`` on one rank's block of a placed leaf, as the sharded
    train step runs it (``params.block_matmul``, model rank 1 of 2): dx and
    the codebook gradient against autograd through the plain chain on the
    same block.  A K block (``w2``) narrows x to its rows and its two
    dictionaries to its own one (the other gets zero); an N block
    (``w1``) takes x whole and its columns' bin sums."""
    from repro_torch.core import params as par
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import sharding as sh

    K, N = 2048, 512
    g = torch.Generator(device=cuda).manual_seed(M + len(name))
    w = torch.randn((K, N), generator=g, device=cuda) * K ** -0.5
    p = par.PasmParams.quantize(w, 16, groups=2).pack()
    x0 = torch.randn((M, K), generator=g, device=cuda).bfloat16()
    mesh = Mesh((1, 2), ("data", "model"), (0, 1), (None, None), cuda)
    leaf = sh.place_params({name: p}, mesh)[name]
    pb, split = par.held_block(leaf, mesh)
    assert split == (name == "w2")
    up = torch.randn((M, pb.shape[1]), generator=g, device=cuda)
    grads = []
    for side in ("kernel", "chain"):
        x = x0.clone().requires_grad_()
        cb = leaf.codebook.clone().requires_grad_()
        before = pm.launches["pasm_matmul"]
        if side == "kernel":
            y, _ = par.block_matmul(x, dataclasses.replace(leaf, codebook=cb),
                                    impl="kernel", mesh=mesh, rows=M)
            assert pm.launches["pasm_matmul"] == before + 1
        else:
            xb = x.narrow(-1, K // 2, K // 2) if split else x
            y = pm.pasm_matmul_plain(xb, pb.idx, cb.narrow(0, 1, 1) if split else cb,
                                     packed=True)
        grads.append(torch.autograd.grad(y, [x, cb], up))
    torch.cuda.synchronize()
    _assert_bwd_close(grads[0], grads[1], torch.bfloat16, f"K1 {name} block M{M}")
    if split:  # the other rank's dictionary and x columns get nothing here
        assert not bool(grads[0][1][0].any()) and not bool(grads[0][0][:, :K // 2].any())


@pytest.mark.parametrize("engine", ["kernel", "kernel_implicit"])
@pytest.mark.parametrize("k,stride,pool,groups,packed", [
    (11, 4, 2, 1, False),   # conv1's geometry, pooled
    (11, 4, 2, 1, True),    # packed: K = 363 takes the pad row
    (3, 1, 1, 2, False),    # conv3's geometry, grouped
    (3, 1, 1, 1, True),
])
def test_k2_backward_matches_chain(cuda, engine, k, stride, pool, groups, packed):
    c_in = 3 if k == 11 else 32
    conv = cv.Conv2D(k=k, c_in=c_in, c_out=48, stride=stride, relu=True)
    hw = 63 if k == 11 else 13
    p = _params((48, c_in, k, k), 16, groups, packed, "NCHW", cuda)
    g = torch.Generator(device=cuda).manual_seed(k + pool)
    img = torch.randn((3, c_in, hw, hw), generator=g, device=cuda)
    with torch.no_grad():
        pre = cv.conv2d(img, p, dataclasses.replace(conv, relu=False), engine="einsum")
        B, C, oh, ow = pre.shape
        ohp, owp = oh // pool, ow // pool
        win = pre[:, :, : ohp * pool, : owp * pool].reshape(B, C, ohp, pool, owp, pool)
        win = win.permute(0, 2, 4, 3, 5, 1).reshape(-1, C)  # window-major rows
    up = _kink_free(win, pool, g).reshape(B, ohp, owp, C).permute(0, 3, 1, 2)
    grads = []
    for eng in (engine, "einsum"):
        x = img.clone().requires_grad_()
        cb = p.codebook.clone().requires_grad_()
        b = p.bias.clone().requires_grad_()
        y = cv.conv2d(x, dataclasses.replace(p, codebook=cb, bias=b), conv, engine=eng,
                      pool=pool)
        grads.append(torch.autograd.grad(y, (x, cb, b), up))
    torch.cuda.synchronize()
    _assert_bwd_close(grads[0], grads[1], torch.float32, f"{engine} k{k} pool{pool}")


def test_train_steps_bitwise_repeatable(cuda):
    """Two identical train steps on the card, LM on K1 (``remat``) and CNN
    QAT, give bitwise equal params and optimizer state under
    ``torch.use_deterministic_algorithms``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, synthetic_batch, synthetic_image_batch
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params
    from repro_torch.train import optimizer as opt
    from repro_torch.train import step as st
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("qwen3-32b", smoke=True), remat=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    with st.deterministic():
        params = quantize_params(
            TT.init_params(cfg, torch.Generator(device=cuda).manual_seed(0)), cfg)
        state = opt.init_opt_state(params)
        batch = synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8), 0,
                                device=cuda)
        step = st.make_train_step(cfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
        before = pm.launches["pasm_matmul"]
        a = step(params, state, batch)[:2]
        assert pm.launches["pasm_matmul"] - before == 7 * cfg.n_layers * 2 + 1
        b = step(params, state, batch)[:2]
        qcfg = dataclasses.replace(alexnet_conv.smoke_config(), impl="einsum")
        cparams = cnn.init_params(qcfg, torch.Generator(device=cuda).manual_seed(0),
                                  device=cuda)
        tree = {"params": cparams, "codebooks": cnn.qat_codebooks(cparams, qcfg)}
        cstate = opt.init_opt_state(tree)
        cbatch = synthetic_image_batch(DataConfig(global_batch=4), 0, chw=qcfg.in_chw,
                                       classes=qcfg.classes, device=cuda)
        cstep = st.make_cnn_train_step(qcfg, opt.AdamWConfig(lr=1e-3, warmup_steps=1))
        c1, c2 = cstep(tree, cstate, cbatch)[:2], cstep(tree, cstate, cbatch)[:2]
    torch.cuda.synchronize()
    for x, y in zip(tree_leaves((a, c1)), tree_leaves((b, c2))):
        assert torch.equal(x.view(torch.uint8) if x.ndim else x,
                           y.view(torch.uint8) if y.ndim else y)


# ---------------------------------------------------------------------------
# MoE: K1 once per expert, each expert with its own dictionaries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T", [4, 64], ids=["stream", "mma"])
def test_moe_ffn_runs_k1_per_expert(cuda, T):
    """``moe_ffn`` on ``kernel`` with bf16 x: one K1 launch per expert and
    matrix plus the shared experts' three, on the route its rows take
    (dropless: each expert's M is T); within a bf16 rounding of ``dequant``
    on the card and of K1's plain version (the CPU), and bitwise repeatable."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import params as P
    from repro_torch.nn import moe as TM

    E, k, D, Fe = 8, 2, 256, 128
    g = torch.Generator(device=cuda).manual_seed(T)

    def q(*shape):
        return P.PasmParams.quantize(torch.randn(shape, generator=g, device=cuda) * 0.05,
                                     16).pack()

    cfg = MoEConfig(n_experts=E, top_k=k, d_expert=Fe, n_shared=1, d_shared=Fe)
    p = {"router": torch.randn((D, E), generator=g, device=cuda) * 0.1,
         "w1": q(E, D, Fe), "w3": q(E, D, Fe), "w2": q(E, Fe, D),
         "shared_w1": q(D, Fe), "shared_w3": q(D, Fe), "shared_w2": q(Fe, D)}
    x = torch.randn((T, D), generator=g, device=cuda).bfloat16()
    route = "stream" if T <= pm.STREAM_MAX_M else "mma"
    pm.reset_launches()
    y, aux = TM.moe_ffn(x, p, cfg, impl="kernel", dropless=True)
    torch.cuda.synchronize()
    assert aux == {} and y.dtype == torch.bfloat16 and y.shape == (T, D)
    assert pm.launches["pasm_matmul"] == 3 * E + 3
    assert pm.k1_routes[route] == 3 * E + 3
    y2, _ = TM.moe_ffn(x, p, cfg, impl="kernel", dropless=True)
    assert torch.equal(y, y2)
    yd, _ = TM.moe_ffn(x, p, cfg, impl="dequant", dropless=True)
    cpu = {n: P.PasmParams(**{f: getattr(w, f).cpu() if torch.is_tensor(getattr(w, f)) else
                              getattr(w, f) for f in ("w", "idx", "codebook", "bias", "kind",
                                                      "shape", "bins", "pad_k")})
           if isinstance(w, P.PasmParams) else w.cpu() for n, w in p.items()}
    yp, _ = TM.moe_ffn(x.cpu(), cpu, cfg, impl="kernel", dropless=True)
    torch.cuda.synchronize()
    for want in (yd, yp):
        want = want.float().to(cuda)
        torch.testing.assert_close(y.float(), want, rtol=0,
                                   atol=2.0 ** -7 * float(want.abs().max()))


# ---------------------------------------------------------------------------
# the recurrent families: K1 at their shapes, K5 at the hybrid's heads
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("M", [1, 4, 384])
@pytest.mark.parametrize("K,N", [
    (768, 3352),      # mamba2-130m in_proj: a ragged last block on both routes
    (768, 50280),     # mamba2-130m lm_head
    (7680, 2560),     # recurrentgemma-2b w2: the split-K reduction
    (2560, 256000),   # recurrentgemma-2b lm_head, the widest head
])
def test_k1_bf16_recurrent_shapes_match_plain(cuda, M, K, N):
    route = "stream" if M <= pm.STREAM_MAX_M else "mma"
    x, idx, cb, bias = _k1_operands(cuda, M, K, N, 1, True)
    before = dict(pm.k1_routes)
    y = pm.pasm_matmul_kernel_call(x, idx, cb, None, packed=True)
    assert pm.k1_routes[route] == before[route] + 1 and y.shape == (M, N)
    _assert_k1_bf16_close(y, x, idx, cb, None, True, False)
    assert torch.equal(y, pm.pasm_matmul_kernel_call(x, idx, cb, None, packed=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_hybrid_heads_match_plain_and_gqa(cuda, dtype):
    """recurrentgemma-2b's attention: 10 query heads over one KV head (G =
    10, not a power of two) at hd 256, causal, with a window no shorter
    than S (the prefill's local mask then masks nothing)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.nn import attention as A

    g = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dtype)
               for s in ((1, 300, 10, 256), (1, 300, 1, 256), (1, 300, 1, 256)))
    qg = q.permute(0, 2, 1, 3).reshape(1, 10, 300, 256).contiguous()
    kg, vg = k[:, :, 0].contiguous(), v[:, :, 0].contiguous()
    before = pm.launches["flash_attention"]
    y = fa.flash_attention_kernel_call(qg, kg, vg, causal=True)
    assert pm.launches["flash_attention"] == before + 1
    _assert_k5_close(y, qg, kg, vg, causal=True, sk_orig=300)
    o = ops.flash_attention(q, k, v, causal=True)
    want = A.gqa_attention(q, k, v, causal=True, window=2048, chunk=128)
    torch.cuda.synchronize()
    t = 1e-5 if dtype == torch.float32 else fa.BF16_TOL
    torch.testing.assert_close(o.float(), want.float(), rtol=t,
                               atol=t * float(v.float().abs().max()))


# ---------------------------------------------------------------------------
# whisper-tiny: the mel stem on K1-K4, K5 non-causal at the encoder's length
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c_in,stride", [(80, 1), (384, 2)], ids=["conv1", "conv2"])
def test_whisper_stem_on_the_four_kernels(cuda, c_in, stride):
    """whisper-tiny's stem convs (k 1×3 on a 1-pixel-high image of 3000
    frames, SAME; conv2 at stride 2 pads 0 left and 1 right) on K1, K2, K3
    and K4 against the einsum engine; K1 ≡ K2 and K3 ≡ K4 bitwise."""
    conv = cv.Conv2D(k=(1, 3), c_in=c_in, c_out=384, stride=stride, padding="same")
    p = _params((384, c_in, 1, 3), 16, 1, False, "NCHW", cuda, seed=c_in)
    g = torch.Generator(device=cuda).manual_seed(stride)
    x = torch.randn((2, c_in, 1, 3000), generator=g, device=cuda)
    want = cv.conv2d(x, p, conv, engine="einsum")
    assert want.shape == (2, 384, 1, 3000 // stride)
    got = {}
    for engine, key in (("kernel", "pasm_matmul"), ("kernel_implicit", "pasm_conv"),
                        ("pas_kernel", "pas_matmul"), ("pas_kernel_implicit", "pas_conv")):
        before = pm.launches[key]
        got[engine] = cv.conv2d(x, p, conv, engine=engine)
        assert pm.launches[key] == before + 1, engine
        torch.cuda.synchronize()
        torch.testing.assert_close(got[engine], want, **TOL)
    assert torch.equal(got["kernel"], got["kernel_implicit"])
    assert torch.equal(got["pas_kernel"], got["pas_kernel_implicit"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1, 17, 1500])
def test_k5_noncausal_at_the_encoder_length(cuda, dtype, Sq):
    """whisper-tiny's attention: 6 heads of hd 64 (G = 1), non-causal,
    against 1500 keys (the encoder's self-attention at Sq = 1500, the
    decoder's cross-attention at a prompt's length): the ragged last key
    tile is masked past 1500."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(Sq)
    q = torch.randn((6, 1, Sq, 64), generator=g, device=cuda).to(dtype)
    k = torch.randn((6, 1500, 64), generator=g, device=cuda).to(dtype)
    v = torch.randn((6, 1500, 64), generator=g, device=cuda).to(dtype)
    before = pm.launches["flash_attention"]
    y = fa.flash_attention_kernel_call(q, k, v, causal=False)
    assert pm.launches["flash_attention"] == before + 1 and y.shape == q.shape
    _assert_k5_close(y, q, k, v, causal=False, sk_orig=1500)


def test_whisper_forward_on_the_card(cuda):
    """The whisper-tiny smoke config, its linears and stem weight-shared,
    on a seeded mel: ``kernel`` (K1 at every linear and both stem convs:
    34 launches) against ``dequant`` within 2.5 % of max |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec as TE
    from repro_torch.models.common import quantize_params

    cfg = get_config("whisper-tiny", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    params = TE.quantize_frontend(quantize_params(
        TE.init_params(cfg, torch.Generator(device=cuda).manual_seed(0)), cfg))
    g = torch.Generator(device=cuda).manual_seed(1)
    mel = torch.randn((2, cfg.n_mels, 2 * cfg.frontend_tokens), generator=g, device=cuda)
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=g, device=cuda, dtype=torch.int32)
    pm.reset_launches()
    lk, _ = TE.forward(params, toks, cfg, frontend_embeds=mel)
    torch.cuda.synchronize()
    per_layer = 6 * cfg.encoder_layers + 10 * cfg.n_layers
    assert pm.launches["pasm_matmul"] == 2 + per_layer
    ld, _ = TE.forward(params, toks, cfg.with_quant(impl="dequant"), frontend_embeds=mel)
    assert lk.shape == ld.shape == (2, 9, cfg.vocab)
    d = (lk.float() - ld.float()).abs().max()
    assert bool(torch.isfinite(lk.float()).all()) and float(d) <= 0.025 * float(
        ld.float().abs().max())


# ---------------------------------------------------------------------------
# half activations (Queue 3) and the sharded plan on the card
# ---------------------------------------------------------------------------


def _stage3(dev, batch=4, c_in=256, c_out=384):
    """AlexNet conv3's shape (c_in → c_out, k3, an 11×11 map): split-K."""
    g = torch.Generator(device=dev).manual_seed(3)
    conv = cv.Conv2D(k=3, c_in=c_in, c_out=c_out, relu=True)
    p = cv.ConvParams.shared(
        torch.randint(0, 16, (c_out, c_in, 3, 3), generator=g, device=dev,
                      dtype=torch.uint8),
        torch.randn(16, generator=g, device=dev) * 0.02,
        bias=torch.randn(c_out, generator=g, device=dev))
    img = torch.randn((batch, c_in, 11, 11), generator=g, device=dev)
    return conv, p, img


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_half_images_on_k1_to_k4(cuda, dtype):
    """A bf16/f16 image on K2 is K1 on the widened operands (x exact, the
    codebook rounded to the image's dtype), bitwise; on K3/K4 it is the
    f32 call on the widened image, bitwise.  K1 takes f16 patches on the
    same widening."""
    conv, p, img = _stage3(cuda)
    x = img.to(dtype)
    t = p.gemm_tensor()
    geom = cv.conv_geom(conv, 11, 11)
    cbw = t.codebook.to(dtype).float()
    patches, _ = cv._im2col(x.float(), conv)
    y1 = pm.pasm_matmul_kernel_call(patches.contiguous(), t.idx.contiguous(), cbw,
                                    p.bias, packed=False, relu=True)
    y2 = ops.pasm_conv2d(x, t, geom, bias=p.bias, relu=True)
    assert torch.equal(y1.reshape(y2.shape), y2)
    torch.testing.assert_close(
        y2, pm.pasm_conv_plain(x, t.idx.contiguous(), t.codebook, p.bias, geom=geom,
                               packed=False, relu=True), **TOL)
    if dtype == torch.float16:  # bf16 patches take K1's bf16 routes instead
        y1h = ops.pasm_matmul(patches.to(dtype), t, bias=p.bias, relu=True)
        assert torch.equal(y1h, y1)
    y4 = ops.pas_conv2d(x, t, geom, bias=p.bias, relu=True)
    assert torch.equal(y4, ops.pas_conv2d(x.float(), t, geom, bias=p.bias, relu=True))
    y3 = ops.pas_matmul(patches.to(dtype), t, bias=p.bias, relu=True)
    assert torch.equal(y3.reshape(y4.shape), y4)


def test_k5_takes_f16(cuda):
    """K5 on f16 q/k/v: the f32 route on the exact widening, rounded to f16."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((4, 2, 200, 64), generator=g, device=cuda).half()
    k, v = (torch.randn((4, 300, 64), generator=g, device=cuda).half() for _ in "kv")
    for causal in (True, False):
        before = pm.launches["flash_attention"]
        y = fa.flash_attention_kernel_call(q, k, v, causal=causal)
        assert y.dtype == torch.float16 and pm.launches["flash_attention"] == before + 1
        want = fa.flash_attention_kernel_call(q.float(), k.float(), v.float(),
                                              causal=causal).half()
        assert torch.equal(y, want)
        torch.testing.assert_close(
            y.float(), fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                                causal=causal), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("c_in,c_out", [(256, 384), (384, 256)])  # conv3, conv5
def test_model_shard_launch_is_bitwise_the_whole_call(cuda, c_in, c_out):
    """A ``model`` block of N planned from the whole call (``whole=``) gives
    exactly the whole call's columns on K1–K4 — the split-K count a half of
    N would pick alone differs (conv3: 1 instead of 4; conv5: 1, not 6)."""
    conv, p, img = _stage3(cuda, c_in=c_in, c_out=c_out)
    t = p.gemm_tensor()
    t = dataclasses.replace(t, idx=t.idx.contiguous())
    geom = cv.conv_geom(conv, 11, 11)
    patches, _ = cv._im2col(img, conv)
    patches = patches.contiguous()
    M, K = patches.shape
    h = c_out // 2
    idx_h, bias_h = t.idx[:, h:].contiguous(), p.bias[h:].contiguous()
    assert pm.simt_plan(M, K, h).splits == 1 < pm.simt_plan(M, K, c_out).splits
    whole = (M, c_out)
    for full, part in (
        (pm.pasm_matmul_kernel_call(patches, t.idx, t.codebook, p.bias,
                                    packed=False, relu=True),
         pm.pasm_matmul_kernel_call(patches, idx_h, t.codebook, bias_h,
                                    packed=False, relu=True, whole=whole)),
        (pm.pasm_conv_kernel_call(img, t.idx, t.codebook, p.bias, geom=geom,
                                  packed=False, relu=True),
         pm.pasm_conv_kernel_call(img, idx_h, t.codebook, bias_h, geom=geom,
                                  packed=False, relu=True, whole=whole)),
        (ph.pas_matmul_kernel_call(patches, t.idx, t.codebook, p.bias, relu=True),
         ph.pas_matmul_kernel_call(patches, idx_h, t.codebook, bias_h, relu=True,
                                   whole=whole)),
        (ph.pas_conv_kernel_call(img, t.idx, t.codebook, p.bias, geom=geom,
                                 relu=True),
         ph.pas_conv_kernel_call(img, idx_h, t.codebook, bias_h, geom=geom,
                                 relu=True, whole=whole)),
    ):
        assert torch.equal(part, full[..., h:])


def test_sharded_forward_at_world_size_one(cuda):
    """``cnn.forward(mesh=)`` on a (1, 1) mesh (no process group: the world
    is this process) is bitwise the unsharded forward on the card."""
    from repro_torch.launch.mesh import make_conv_mesh

    cfg = alexnet_conv.smoke_config()
    mesh = make_conv_mesh((1, 1), device=cuda)
    params = cnn.init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    q = cnn.quantize(params, cfg)
    qm = cnn.quantize(params, cfg, mesh=mesh)
    x = torch.randn((5, *cfg.in_chw), device=cuda)
    for impl in ("kernel", "kernel_implicit", "pas_kernel", "einsum"):
        c = dataclasses.replace(cfg, impl=impl)
        assert torch.equal(cnn.forward(qm, x, c, mesh=mesh), cnn.forward(q, x, c))
