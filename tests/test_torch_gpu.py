"""K1 and K2 on the card against their plain versions (``-m gpu``).

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
from repro_torch.kernels import ops
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


@pytest.mark.parametrize("layout,padding,pool,packed,groups", [
    ("NCHW", "valid_centred", 2, False, 1),
    ("NHWC", "same", 2, True, 1),
    ("NCHW", "same", 1, True, 5),      # packed groups need even K/G: 150/5
    ("NHWC", "valid", 3, False, 3),
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


def test_smoke_forward_on_the_card(cuda):
    cfg = alexnet_conv.smoke_config()
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = cnn.quantize(cnn.init_params(cfg, gen, device=cuda), cfg)
    x = torch.randn((4, 3, 32, 32), generator=gen, device=cuda)
    want = cnn.forward(q, x, dataclasses.replace(cfg, impl="einsum"))
    for impl in ("kernel", "kernel_implicit"):
        pm.reset_launches()
        got = cnn.forward(q, x, dataclasses.replace(cfg, impl=impl))
        key = "pasm_matmul" if impl == "kernel" else "pasm_conv"
        assert pm.launches[key] == len(cfg.layers)
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)
    assert np.isfinite(got.cpu().numpy()).all()


def test_kernels_raise_on_grad(cuda):
    x = torch.randn((8, 16), device=cuda, requires_grad=True)
    idx = torch.zeros((16, 4), dtype=torch.uint8, device=cuda)
    cb = torch.zeros((1, 4), device=cuda)
    with pytest.raises(RuntimeError, match="QAT/training slice"):
        pm.pasm_matmul_kernel_call(x, idx, cb, packed=False)
