"""K6, split-KV decode attention: its wrapper's plain route on the CPU, and
the kernel on the card (``-m gpu``).

On CPU tensors ``kernels/decode_attention.py::attend`` and
``nn/attention.py::decode_attention`` must give the bits the plain decode
gave before K6 existed (:func:`_decode_before`, kept here verbatim): ragged
per-slot positions, a dead slot whose position ran past the cache, a
window, no valid row, every group size and head dim of the registry, bf16
and f32 caches, and a sequence-sharded cache folded one rank at a time.
The gpu tests hold K6 to the plain version on the same grid, bit for bit
on a repeat, and count its launches; they take the ``cuda`` fixture, which
skips without a card, so every worker collects the same tests.  On a card::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_decode_attention.py
"""
import itertools

import pytest
import torch

from repro_torch.core._f32 import matmul_f32
from repro_torch.kernels import decode_attention as K6
from repro_torch.kernels import pasm_matmul as pm
from repro_torch.nn import attention as A

GROUPS = (1, 2, 4, 8, 12)
HDS = (64, 80, 128, 192)
DTYPES = (torch.bfloat16, torch.float32)
GRID = list(itertools.product(GROUPS, HDS, DTYPES))


def _valid_before(pos, S, window, offset=0):
    k_pos = offset + torch.arange(S, device=pos.device)
    valid = k_pos[None, :] < pos[:, None]
    if window is not None:
        valid = valid & (k_pos[None, :] >= pos[:, None] - window)
    return valid


def _scores_before(q, cache, window, offset):
    B, _, H, hd = q.shape
    _, S, KV, _ = cache.k.shape
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, 1, hd).float()
    kt = cache.k.permute(0, 2, 3, 1).float()[:, :, None]  # (B,KV,1,hd,S)
    s = matmul_f32(qg, kt)[:, :, :, 0] * scale  # (B,KV,G,S)
    valid = _valid_before(cache.pos, S, window, offset)
    return torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))


def _decode_before(q, cache, *, window=None):
    """The unsharded decode_attention before K6, verbatim but for its span."""
    B, _, H, hd = q.shape
    s = _scores_before(q, cache, window, 0)
    p = torch.softmax(s, dim=-1)
    vt = cache.v.permute(0, 2, 1, 3).float()[:, :, None]  # (B,KV,1,S,hd)
    o = matmul_f32(p.to(cache.v.dtype).float()[:, :, :, None], vt)[:, :, :, 0]
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _partial_before(q, cache, offset, *, window=None):
    """A sequence-sharded rank's (m, l, o) before K6."""
    s = _scores_before(q, cache, window, offset)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    vt = cache.v.permute(0, 2, 1, 3).float()[:, :, None]
    o = matmul_f32(p.to(cache.v.dtype).float()[:, :, :, None], vt)[:, :, :, 0]
    return m, p.sum(dim=-1), o


def _operands(G, hd, dtype, *, B=4, S=600, KV=2, device="cpu", seed=0):
    """q and a cache with ragged positions: one row, a split's edge, the
    cache's end, and a dead slot whose counter ran past it."""
    g = torch.Generator().manual_seed(seed + 7 * G + hd)
    q = torch.randn((B, 1, KV * G, hd), generator=g).to(dtype).to(device)
    k = (2 * torch.randn((B, S, KV, hd), generator=g)).to(dtype).to(device)
    v = torch.randn((B, S, KV, hd), generator=g).to(dtype).to(device)
    pos = torch.tensor([1, K6.CHUNK + 1, S, S + 37][:B], dtype=torch.int32, device=device)
    return q, A.KVCache(k=k, v=v, pos=pos)


@pytest.mark.parametrize("G,hd,dtype", GRID)
def test_cpu_route_is_the_decode_before(G, hd, dtype):
    window = 100 if hd == 80 else None  # stablelm's hd also takes a window
    q, cache = _operands(G, hd, dtype)
    before = pm.launches["decode_attention"]
    want = _decode_before(q, cache, window=window)
    got = A.decode_attention(q, cache, window=window)
    assert torch.equal(got, want) and got.dtype == dtype
    assert torch.equal(K6.attend(q, cache.k, cache.v, cache.pos, window=window), want)
    assert pm.launches["decode_attention"] == before  # the CPU path launches nothing


@pytest.mark.parametrize("window", [None, 0, 3])
def test_cpu_route_without_a_valid_row(window):
    """pos 0 (or a window of 0) leaves no row: the plain softmax over
    all-masked scores, the mean of every row's v."""
    q, cache = _operands(4, 64, torch.float32, B=2, S=300)
    cache = A.KVCache(k=cache.k, v=cache.v, pos=torch.tensor([0, 5], dtype=torch.int32))
    got = A.decode_attention(q, cache, window=window)
    assert torch.equal(got, _decode_before(q, cache, window=window))
    torch.testing.assert_close(got[0, 0, :4], cache.v[0, :, 0].mean(0).expand(4, -1))


@pytest.mark.parametrize("dtype,window", [(torch.bfloat16, None), (torch.float32, None),
                                          (torch.bfloat16, 150)])
def test_cpu_route_sequence_sharded(dtype, window):
    """Three ranks' blocks of 200 positions, each rank's partial folded one
    rank at a time by combine_partials: the pre-K6 partials bitwise, and
    the unsharded decode within rounding."""
    q, cache = _operands(4, 64, dtype, S=600)
    cache = A.KVCache(k=cache.k, v=cache.v,
                      pos=torch.tensor([150, 201, 450, 641], dtype=torch.int32))
    parts, want = [], []
    for r in range(3):
        block = A.KVCache(k=cache.k[:, r * 200:(r + 1) * 200], v=cache.v[:, r * 200:(r + 1) * 200],
                          pos=cache.pos)
        got = K6.attend(q, block.k, block.v, block.pos, window=window, offset=r * 200,
                        partial=True)
        ref = _partial_before(q, block, r * 200, window=window)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
        parts.append(got)
        want.append(ref)
    o = A.combine_partials(parts).reshape(q.shape).to(dtype)
    assert torch.equal(o, A.combine_partials(want).reshape(q.shape).to(dtype))
    whole = _decode_before(q, cache, window=window)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(o.float(), whole.float(), rtol=tol, atol=tol)


def _refusal(case):
    q, cache = _operands(4, 64, torch.bfloat16, B=2, S=64)
    k, v, pos = cache.k, cache.v, cache.pos
    if case == "head dim":
        q, k, v = q[..., :48], k[..., :48].contiguous(), v[..., :48].contiguous()
    elif case == "group":
        q = torch.zeros((2, 1, 2 * (K6.MAX_GROUP + 1), 64), dtype=q.dtype)
    elif case == "ragged heads":
        q = q[:, :, :7]
    elif case == "dtype":
        k, v = k.half(), v.half()
    elif case == "int8 cache":
        k, v = k.to(torch.int8), v.to(torch.int8)
    elif case == "layout":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)  # (B, KV, S, hd) in memory
    elif case == "pos dtype":
        pos = pos.long()
    return q, k, v, pos


@pytest.mark.parametrize("case,err,match", [
    ("head dim", ValueError, "head dim 48"),
    ("group", ValueError, "query heads"),
    ("ragged heads", ValueError, "query heads"),
    ("dtype", TypeError, "must be in"),
    ("int8 cache", TypeError, "must be in"),
    ("layout", ValueError, "row-major"),
    ("pos dtype", TypeError, "int32"),
    ("cpu", ValueError, "CUDA tensors"),
])
def test_kernel_call_refuses(case, err, match):
    with pytest.raises(err, match=match):
        K6.decode_attention_kernel_call(*_refusal(case))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _assert_k6_close(y, q, k, v, pos, *, window=None):
    """K6 against decode_attention_plain.  f32 throughout: sums in another
    order, within 1e-5.  A bf16 cache or output: the weights are rounded to
    bf16 relative to their split's running max (2^-9·Σ_j p_j·|v_j| at
    most) and both round the output, so |Δ| <= 2^-7·(|plain| + Σ_j p_j·|v_j|)
    (K5's BF16_TOL form; the sum is the plain version on |v|)."""
    want = K6.decode_attention_plain(q, k, v, pos, window=window)
    assert y.dtype == want.dtype and y.shape == want.shape
    if y.dtype == k.dtype == torch.float32:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        return
    pv = K6.decode_attention_plain(q, k, v.abs(), pos, window=window)
    d = (y.float() - want.float()).abs()
    lim = K6.BF16_TOL * (want.float().abs() + pv.float())
    assert bool(torch.isfinite(y.float()).all()) and bool((d <= lim).all()), \
        f"max |Δ| {float(d.max()):.3e}, {int((d > lim).sum())} over tolerance"


@pytest.mark.gpu
@pytest.mark.parametrize("G,hd,dtype", GRID)
def test_k6_matches_plain(cuda, G, hd, dtype):
    window = 100 if hd == 80 else None
    q, cache = _operands(G, hd, dtype, device=cuda)
    before = pm.launches["decode_attention"]
    y = K6.decode_attention_kernel_call(q, cache.k, cache.v, cache.pos, window=window)
    again = K6.decode_attention_kernel_call(q, cache.k, cache.v, cache.pos, window=window)
    torch.cuda.synchronize()
    assert pm.launches["decode_attention"] == before + 2
    assert torch.equal(y, again)
    _assert_k6_close(y, q, cache.k, cache.v, cache.pos, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("qdt,cdt", [(torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("hd", [16, 32, 256])
def test_k6_other_dims_and_mixed_dtypes(cuda, qdt, cdt, hd):
    """The head dims past the grid, a group of 6 (internvl2), and q in
    another dtype than the cache (the output takes q's)."""
    q, cache = _operands(6, hd, cdt, device=cuda)
    q = q.to(qdt)
    y = K6.decode_attention_kernel_call(q, cache.k, cache.v, cache.pos)
    torch.cuda.synchronize()
    _assert_k6_close(y, q, cache.k, cache.v, cache.pos)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", [1, K6.MAX_GROUP])
@pytest.mark.parametrize("hd", K6.HEAD_DIMS)
def test_k6_every_head_dim_at_the_group_extremes(cuda, hd, G, dtype):
    """The launch shapes' extremes: the fewest and the most query heads a
    block serves, at every head dim the kernel is built for."""
    q, cache = _operands(G, hd, dtype, B=2, S=300, KV=1, device=cuda)
    y = K6.decode_attention_kernel_call(q, cache.k, cache.v, cache.pos)
    torch.cuda.synchronize()
    _assert_k6_close(y, q, cache.k, cache.v, cache.pos)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [None, 0])
def test_k6_without_a_valid_row(cuda, window):
    q, cache = _operands(4, 128, torch.bfloat16, B=2, device=cuda)
    pos = torch.tensor([0, 5], dtype=torch.int32, device=cuda)
    y = K6.decode_attention_kernel_call(q, cache.k, cache.v, pos, window=window)
    torch.cuda.synchronize()
    _assert_k6_close(y, q, cache.k, cache.v, pos, window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_k6_sequence_sharded(cuda, dtype):
    """Each rank's partial from K6 (a strided block, as the sharded cache's
    write leaves it), folded one rank at a time, against the whole cache."""
    q, cache = _operands(4, 128, dtype, S=600, device=cuda)
    pos = torch.tensor([150, 201, 450, 641], dtype=torch.int32, device=cuda)
    parts = []
    for r in range(3):
        k = torch.cat([cache.k[:, r * 200:(r + 1) * 200], cache.k[:, :1]], dim=1)[:, :200]
        v = torch.cat([cache.v[:, r * 200:(r + 1) * 200], cache.v[:, :1]], dim=1)[:, :200]
        m, l, o = K6.decode_attention_kernel_call(q, k, v, pos, offset=r * 200, partial=True)
        G = q.shape[2] // k.shape[2]
        assert m.shape == l.shape == (4, 2, G) and o.shape == (4, 2, G, 128)
        parts.append((m, l, o))
    y = A.combine_partials(parts).reshape(q.shape).to(dtype)
    torch.cuda.synchronize()
    _assert_k6_close(y, q, cache.k, cache.v, pos)


@pytest.mark.gpu
def test_decode_attention_launches_k6_once(cuda):
    q, cache = _operands(4, 128, torch.bfloat16, device=cuda)
    before = pm.launches["decode_attention"]
    y = A.decode_attention(q, cache)
    torch.cuda.synchronize()
    assert pm.launches["decode_attention"] == before + 1
    assert torch.equal(y, K6.decode_attention_kernel_call(q, cache.k, cache.v, cache.pos))
