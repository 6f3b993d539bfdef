"""K1's route plan (``pasm_matmul.k1_plan``): a pure function of the shapes
and the activation dtype, checked on the CPU.  The kernels it picks run only
on the card (``tests/test_torch_gpu.py``); here the wrapper takes the plain
version whatever the route, and the plan's choices are held to the rules the
bf16 routes rely on."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import pasm_matmul as pm

BF16, F32 = torch.bfloat16, torch.float32
# (K, N) of qwen3-32b's wq, w1, w2 and lm_head: the served LM's K1 shapes
LM = {"wq": (5120, 8192), "w1": (5120, 25600), "w2": (25600, 5120),
      "lm_head": (5120, 151936)}
SWEEP_M = (1, 2, 4, 8, 16, 17, 32, 64, 128, 384, 512, 3072)


@pytest.mark.parametrize("M", SWEEP_M)
@pytest.mark.parametrize("name", sorted(LM))
def test_f32_and_pool_take_simt(M, name):
    K, N = LM[name]
    assert pm.k1_plan(M, K, N, F32).route == "simt"
    assert pm.k1_plan(4 * M, K, N, BF16, pool=2).route == "simt"
    assert pm.k1_plan(4 * M, K, N, F32, pool=2) == pm.k1_plan(4 * M, K, N, BF16, pool=2)


@pytest.mark.parametrize("name", sorted(LM))
def test_bf16_splits_at_m0(name):
    K, N = LM[name]
    m0 = pm.STREAM_MAX_M
    assert [pm.k1_plan(M, K, N, BF16).route for M in (1, m0, m0 + 1, 384)] == \
        ["stream", "stream", "mma", "mma"]


@pytest.mark.parametrize("route", ["stream", "mma"])
@pytest.mark.parametrize("name", sorted(LM))
def test_split_count_does_not_depend_on_m(route, name):
    """A row sums in the same order whatever M is: the split-K partition is
    set by K and N alone, and so is every row's place in its tile."""
    K, N = LM[name]
    plans = [p for p in (pm.k1_plan(M, K, N, BF16, packed=True) for M in SWEEP_M)
             if p.route == route]
    assert len(plans) > 1 and len({p.splits for p in plans}) == 1
    # each split takes at least MIN_SPLIT_K rows of K
    assert plans[0].splits == 1 or K // plans[0].splits >= pm.MIN_SPLIT_K


def test_w2_fills_the_card_at_decode():
    K, N = LM["w2"]
    p = pm.k1_plan(4, K, N, BF16)
    assert p.route == "stream" and p.splits > 1 and p.blocks >= pm.SMS
    # lm_head has enough column strips without splitting K
    assert pm.k1_plan(4, *LM["lm_head"], BF16).splits == 1


@pytest.mark.parametrize("M", SWEEP_M)
@pytest.mark.parametrize("name", sorted(LM))
def test_scratch_and_blocks(M, name):
    K, N = LM[name]
    p = pm.k1_plan(M, K, N, BF16)
    assert p.cols == (pm.STREAM_COLS if p.route == "stream" else pm.MMA_BN)
    cols = -(-N // p.cols)
    assert p.scratch == (p.splits * M * N if p.splits > 1 else 0)
    assert p.blocks == cols * p.splits * -(-M // p.tile)
    if p.route == "stream":
        assert p.tile == (8 if M <= 8 else 16)
    else:
        assert p.tile == pm.MMA_BM


# (M at batch 32, K, N, pool) of AlexNet's five conv stages: K1 simt's and
# K2's shapes on the served model
ALEXNET = {"conv1": (93312, 363, 96, 2), "conv2": (15488, 2400, 256, 2),
           "conv3": (2592, 2304, 384, 1), "conv4": (1568, 3456, 384, 1),
           "conv5": (512, 3456, 256, 2)}


@pytest.mark.parametrize("M,pool", [(64, 1), (36, 3), (256, 16), (144, 12), (400, 10)])
def test_simt_plan_is_the_old_tile(M, pool):
    """The row tile follows from the pool window alone: 128 rows, or 256
    when a window holds more than 128 (pool 12, 16); a block owns whole
    windows.  The 256-row tile takes 64 columns."""
    p = pm.k1_plan(M, 2400, 70, F32, pool=pool)
    pw = pool * pool
    assert p.route == "simt" and p.tile == pm._pool_bm(pool)
    assert p.tile == (128 if pw <= 128 else 256)
    rows = p.tile - p.tile % pw
    assert p.cols == (96 if p.tile == 128 else 64)
    assert p.blocks == -(-M // rows) * -(-70 // p.cols) * p.splits
    assert p == pm.simt_plan(M, 2400, 70, pool)


@pytest.mark.parametrize("N,cols", [(96, 96), (256, 128), (384, 128), (64, 64),
                                    (10, 64), (70, 96), (130, 96), (160, 96),
                                    (200, 128), (1000, 128)])
def test_simt_columns_pad_n_least(N, cols):
    """The column tile of SIMT_BNS that pads N least, the larger on a tie:
    conv1's N = 96 takes 96 and wastes nothing."""
    p = pm.simt_plan(1000, 363, N)
    assert p.cols == cols
    waste = {b: -(-N // b) * b for b in pm.SIMT_BNS}
    assert waste[cols] == min(waste.values())


@pytest.mark.parametrize("name", sorted(ALEXNET))
def test_simt_splits_depend_on_k_and_n_only(name):
    """Every output sums one fmaf chain a split, in the same order whatever
    M is: the split count is a function of K and N (and so is K2's, which
    takes the same plan over batch · P_rows rows).  conv3–conv5 split,
    conv1 and conv2 do not."""
    M, K, N, pool = ALEXNET[name]
    plans = {pm.simt_plan(m * pool * pool, K, N, pool).splits
             for m in (1, 7, 64, M // (pool * pool), 10 * M)}
    assert len(plans) == 1
    splits = plans.pop()
    assert splits == {"conv1": 1, "conv2": 1, "conv3": 4, "conv4": 6,
                      "conv5": 6}[name]
    assert splits == 1 or K // splits >= pm.SIMT_SPLIT_K
    # f32 takes this plan, and so does a pooled bf16 x (widened)
    assert pm.k1_plan(M, K, N, F32, pool=pool) == pm.simt_plan(M, K, N, pool)
    assert pm.k1_plan(M, K, N, BF16, pool=2) == pm.simt_plan(M, K, N, 2)


@pytest.mark.parametrize("name", sorted(ALEXNET))
def test_simt_blocks_and_scratch(name):
    """Blocks: row tiles x column tiles x splits; the split-K scratch holds
    every split's M x N partial sums.  Batch 32 fills at least 48 blocks
    on every stage (an unsplit 64 x 64 tile gave conv5 32)."""
    M, K, N, pool = ALEXNET[name]
    p = pm.simt_plan(M, K, N, pool)
    rows = p.tile - p.tile % (pool * pool)
    assert p.blocks == -(-M // rows) * -(-N // p.cols) * p.splits
    assert p.scratch == (p.splits * M * N if p.splits > 1 else 0)
    assert p.blocks >= 48


def test_simt_split_bounds():
    """A wide layer (N > SIMT_SPLIT_MAX_N) or a small weight matrix never
    splits, and no layer takes more than SIMT_MAX_SPLITS parts, each of at
    least SIMT_SPLIT_K rows."""
    assert pm.simt_plan(4, 25600, 5120).splits == 1
    assert pm.simt_plan(4, 100000, 64).splits == pm.SIMT_MAX_SPLITS
    assert pm.simt_plan(4, 1000, 500).splits == 1  # 1000 // 576 = 1
    assert pm.simt_plan(4, 2000, 100).splits == 1  # K·N below the floor
    for K in (576, 1151, 1152, 4000):
        s = pm.simt_plan(4, K, 512).splits
        assert 1 <= s <= pm.SIMT_MAX_SPLITS and (s == 1 or K // s >= pm.SIMT_SPLIT_K)


@pytest.mark.parametrize("M", [4, 384])
def test_bf16_routes_take_what_their_tables_hold(M):
    """Up to MAX_BF16_GROUPS dictionaries, and with packed indices an even
    K / G (a byte's two rows in one dictionary); any other bf16 shape takes
    the SIMT kernel, which pairs nothing."""
    fast = "stream" if M <= pm.STREAM_MAX_M else "mma"
    g = pm.MAX_BF16_GROUPS
    for K, groups, packed, route in ((512, 1, True, fast), (512, g, True, fast),
                                     (90, 2, True, "simt"), (90, 2, False, fast),
                                     (512, g + 1, True, "simt"),
                                     (510, 3, False, "simt"), (520, 130, True, "simt")):
        p = pm.k1_plan(M, K, 64, BF16, packed=packed, groups=groups)
        assert p.route == route, (K, groups, packed)
        assert p == pm.k1_plan(M, K, 64, F32) or p.route != "simt"


def _operands(M, K, N, groups, packed, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(BF16)
    idx = torch.from_numpy(rng.integers(0, 256 if packed else 16,
                                        (K // 2 if packed else K, N)).astype(np.uint8))
    cb = torch.from_numpy(rng.standard_normal((groups, 16)).astype(np.float32))
    return x, idx, cb


@pytest.mark.parametrize("M,dtype,groups,route", [
    (5, BF16, 2, "stream"), (40, BF16, 2, "mma"), (5, F32, 2, "simt"),
    (5, BF16, 3, "simt"),
])
def test_wrapper_on_the_cpu_runs_the_plain_version(M, dtype, groups, route):
    """On a CPU tensor every route is the plain version, and nothing counts
    as a launch."""
    x, idx, cb = _operands(M, 96, 40, groups, True)
    x = x.to(dtype)
    assert pm.k1_plan(M, 96, 40, dtype, packed=True, groups=groups).route == route
    pm.reset_launches()
    y = pm.pasm_matmul_kernel_call(x, idx, cb, packed=True, relu=True)
    want = pm.pasm_matmul_plain(x, idx, cb, packed=True, relu=True)
    assert torch.equal(y, want) and y.dtype == F32
    assert pm.launches["pasm_matmul"] == 0 and not any(pm.k1_routes.values())


@pytest.mark.parametrize("K,groups", [(90, 6), (130 * 2, 130), (96, 3)])
def test_wrapper_sends_what_the_bf16_routes_cannot_pair_to_simt(K, groups):
    """Odd K / G (90 / 6 = 15) or more dictionaries than the tables hold:
    the bf16 x runs on the SIMT route, whose result is the f32 call's on the
    widened x."""
    x, idx, cb = _operands(4, K, 8, groups, True)
    assert pm.k1_plan(4, K, 8, BF16, packed=True, groups=groups).route == "simt"
    y = pm.pasm_matmul_kernel_call(x, idx, cb, packed=True)
    want = pm.pasm_matmul_kernel_call(x.float(), idx, cb.to(BF16).float(), packed=True)
    assert torch.equal(y, want)
