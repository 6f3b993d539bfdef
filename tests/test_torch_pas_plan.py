"""K3/K4's launch plan (``pas_histogram.pas_plan``): a pure function of the
shapes, checked on the CPU.  The kernels run only on the card
(``tests/test_torch_gpu.py``); here the plan is held to what the kernels rely
on, with the grid decoded as ``csrc/pas_common.cuh::pas_tile`` decodes it,
and the wrappers on a CPU tensor are held to their plain versions."""
import numpy as np
import pytest
import torch

from repro_torch.core import conv as cv
from repro_torch.kernels import pas_histogram as ph
from repro_torch.kernels import pasm_matmul as pm

POOLS = [p for p in range(1, 17) if pm.pool_plan_exists(p)]
# (rows per image, K, N, pool) of the five AlexNet conv stages (3x224x224,
# configs/alexnet_conv.py): K includes conv1's pack-time pad row
ALEXNET = {"conv1": (2916, 364, 96, 2), "conv2": (484, 2400, 256, 2),
           "conv3": (81, 2304, 384, 1), "conv4": (49, 3456, 384, 1),
           "conv5": (16, 3456, 256, 2)}
INT_MAX = 2 ** 31 - 1


def _blocks(plan, M, K, N):
    """Every block's rows, columns and K range, decoded from its index as
    ``pas_tile`` does (columns fastest, then the split, then the rows)."""
    cols = -(-N // plan.cols)
    stages = -(-K // ph.PAS_BK)
    per = -(-stages // plan.splits)
    for block in range(plan.blocks):
        col, split, rb = block % cols, block // cols % plan.splits, block // cols // plan.splits
        m0, n0 = rb * plan.rows, col * plan.cols
        kb = min(K, split * per * ph.PAS_BK)
        ke = min(K, kb + per * ph.PAS_BK)
        yield (range(m0, min(M, m0 + plan.rows)), range(n0, min(N, n0 + plan.cols)),
               split, range(kb, ke))


def test_admitted_pools():
    assert POOLS == [1, 2, 3, 4, 5, 6, 8, 10, 12, 16]
    with pytest.raises(ValueError, match="unfused"):
        ph.pas_plan(49, 64, 8, 16, 7)


@pytest.mark.parametrize("pool", POOLS)
def test_whole_pool_windows_per_block(pool):
    pw = pool * pool
    p = ph.pas_plan(pw * 40, 300, 70, 16, pool)
    assert p.tile in ph.PAS_TILES and p.cols == ph.PAS_TILES[p.tile]
    assert 0 < p.rows <= p.tile and p.rows % pw == 0
    assert p.rows == p.tile - p.tile % pw
    # the smaller tile whenever a window fits it: 128 x 16 outputs
    assert p.tile == (128 if pw <= 128 else 256)
    # every block row tile starts on a window
    for rows, _, _, _ in _blocks(p, pw * 40, 300, 70):
        assert rows.start % pw == 0 and len(rows) % pw == 0


@pytest.mark.parametrize("M,K,N,pool", [
    (1, 1, 1, 1), (127, 15, 15, 1), (129, 17, 17, 1), (300, 1000, 33, 1),
    (36 * 7, 2400, 40, 3), (144 * 3, 40, 9, 12), (512, 3456, 256, 2),
    (100, 4100, 20, 1), (256, 2048, 8, 16),
])
def test_rows_and_columns_covered_once(M, K, N, pool):
    p = ph.pas_plan(M, K, N, 16, pool)
    seen = np.zeros((p.splits, M, N), dtype=np.int64)
    kranges = {}
    for rows, cols, split, ks in _blocks(p, M, K, N):
        seen[split, rows.start:rows.stop, cols.start:cols.stop] += 1
        assert kranges.setdefault(split, ks) == ks  # one K range a split
    assert (seen == 1).all()
    # the splits' K ranges partition [0, K) in order, in whole stages
    bounds = [kranges[s] for s in range(p.splits)]
    assert bounds[0].start == 0 and bounds[-1].stop == K
    for a, b in zip(bounds, bounds[1:]):
        assert a.stop == b.start and a.start % ph.PAS_BK == 0
    assert p.blocks == -(-M // p.rows) * -(-N // p.cols) * p.splits


@pytest.mark.parametrize("pool", [1, 2, 12])
def test_passes_cover_every_bin(pool):
    for B in range(1, 257):
        p = ph.pas_plan(4 * pool * pool, 64, 8, B, pool)
        assert p.passes == -(-B // ph.PAS_BINS)
        # the last pass holds 1..16 bins, and together they hold B
        assert 0 < B - (p.passes - 1) * ph.PAS_BINS <= ph.PAS_BINS


@pytest.mark.parametrize("name", sorted(ALEXNET))
def test_split_count_does_not_depend_on_m(name):
    """A row sums in the same order whatever M is: the split-K partition is
    set by K and N alone (and the rows a block owns by the pool)."""
    _, K, N, pool = ALEXNET[name]
    pw = pool * pool
    plans = [ph.pas_plan(m * pw, K, N, 16, pool) for m in (1, 3, 16, 64, 1000, 40000)]
    assert len({(p.splits, p.tile, p.rows, p.cols) for p in plans}) == 1
    s = plans[0].splits
    assert s == 1 or K // s >= ph.PAS_SPLIT_K
    for B in (1, 4, 256):  # nor on the dictionary
        assert ph.pas_plan(pw, K, N, B, pool).splits == s


def test_splits_long_narrow_layers_only():
    """Split-K where K is long and N narrow: conv4 and conv5 (K 3456) split,
    conv1-conv3 (K 364..2400) do not, nor does a wide layer."""
    splits = {n: ph.pas_plan(r, K, N, 16, pool).splits
              for n, (r, K, N, pool) in ALEXNET.items()}
    assert splits == {"conv1": 1, "conv2": 1, "conv3": 1, "conv4": 2, "conv5": 2}
    assert ph.pas_plan(64, 25600, 5120, 16).splits == 1


@pytest.mark.parametrize("batch", [1, 32])
@pytest.mark.parametrize("name", sorted(ALEXNET))
def test_grid_within_cuda_limits(name, batch):
    """K3 and K4 launch one grid dimension over the rows of every image
    (K4's implicit patch matrix runs image after image, as K3's does)."""
    rows, K, N, pool = ALEXNET[name]
    p = ph.pas_plan(batch * rows, K, N, 16, pool)
    assert 0 < p.blocks <= INT_MAX
    assert p.scratch == (p.splits * batch * rows * N if p.splits > 1 else 0)


@pytest.mark.parametrize("pool", [1, 2, 3])
def test_wrappers_on_cpu_run_the_plain_versions(pool):
    rng = np.random.default_rng(pool)
    pw = pool * pool
    x = torch.from_numpy(rng.standard_normal((pw * 9, 50)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 20, (50, 7)).astype(np.uint8))
    cb = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(7).astype(np.float32))
    pm.reset_launches()
    y = ph.pas_matmul_kernel_call(x, idx, cb, bias, relu=True, pool=pool)
    assert torch.equal(y, ph.pas_matmul_plain(x, idx, cb, bias, relu=True, pool=pool))
    conv = cv.Conv2D(k=3, c_in=2, c_out=7, padding="same")
    g = cv.conv_geom(conv, 6 * pool, 6 * pool, pool=pool)
    img = torch.from_numpy(rng.standard_normal((2, 2, 6 * pool, 6 * pool)).astype(np.float32))
    idx4 = torch.from_numpy(rng.integers(0, 16, (g.conv_k, 7)).astype(np.uint8))
    y4 = ph.pas_conv_kernel_call(img, idx4, cb, bias, geom=g, relu=True)
    assert torch.equal(y4, ph.pas_conv_plain(img, idx4, cb, bias, geom=g, relu=True))
    assert pm.launches["pas_matmul"] == pm.launches["pas_conv"] == 0
