"""Attention: GQA with qk-norm, chunked (flash-style) causal/local, decode.

Port of ``repro.nn.attention``.  All shapes are ``(batch, seq, heads,
head_dim)``.  GQA reshapes the query heads into ``(kv_head, group)`` so the
contraction never repeats K/V.  The chunked path walks KV blocks with an
online softmax (a Python loop where JAX scans), so a long prefill never
makes an ``(S, S)`` score matrix.  The arithmetic is the JAX package's:
scores in f32 from exact widenings, probabilities cast to ``v``'s dtype
before the value product, the sum in f32, output in ``q``'s dtype.

The caches are functional, as in the JAX package: an update returns a new
cache and leaves its input untouched (the serving engine reuses a fresh
template cache for every admission).

A cache placed with its sequence over ``model`` (``models/sharding.py::
cache_pspecs``' branch for KV heads that do not divide the axis; its
``seq_shards`` > 1) holds this rank's block of positions: slot ``s`` lives
on rank ``s // (S / seq_shards)``.  Given ``mesh=``, an update writes only
the rank's positions, and decode computes each rank's f32 partial ``(m, l,
o)`` over its block for every head (:func:`softmax_partial`), all-gathers
them and folds them in rank order (:func:`combine_partials`), so every rank
holds the same bits.  A cache with ``seq_shards`` 1 runs the unsharded code
untouched.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import trace
from repro_torch.core._f32 import matmul_f32
from repro_torch.kernels import decode_attention as K6
from repro_torch.kernels.decode_attention import softmax_partial, valid_rows

__all__ = [
    "softmax_partial",
    "combine_partials",
    "combine_over",
    "KVCache",
    "QuantKVCache",
    "init_kv_cache",
    "init_quant_kv_cache",
    "gqa_attention",
    "decode_attention",
    "decode_attention_quant",
    "update_cache",
    "update_quant_cache",
]

_NEG_INF = -1e30


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (B, S, KV, hd)
    v: torch.Tensor
    pos: torch.Tensor  # (B,) int32 — tokens already in cache, PER SLOT
    seq_shards: int = 1  # ranks along ``model`` the positions split over


def init_kv_cache(batch: int, seq: int, n_kv: int, hd: int,
                  dtype=torch.bfloat16, *, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((batch, seq, n_kv, hd), dtype=dtype, device=device),
        v=torch.zeros((batch, seq, n_kv, hd), dtype=dtype, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _chunk_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Cq,KV,G,hd) · k (B,Ck,KV,hd) → (B,KV,G,Cq,Ck) f32."""
    qt = q.permute(0, 2, 3, 1, 4).float()  # (B,KV,G,Cq,hd)
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]  # (B,KV,1,hd,Ck)
    return matmul_f32(qt, kt) * scale


def _weighted_values(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p (B,KV,G,Cq,Ck) in v's dtype · v (B,Ck,KV,hd) → (B,KV,G,Cq,hd) f32."""
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]  # (B,KV,1,Ck,hd)
    return matmul_f32(p.to(v.dtype).float(), vt)


def _mask(q_pos, k_pos, kvalid: int, causal: bool, window: Optional[int]):
    mask = (k_pos[None, :] < kvalid).expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if window is not None:
        mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
    return mask


def gqa_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    chunk: int = 1024,
    q_offset: int = 0,
) -> torch.Tensor:
    """Chunked-KV online-softmax attention.

    q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd); H % KV == 0.  ``window``
    limits attention to the last ``window`` positions (local attention).
    ``q_offset`` is the absolute position of q[0] relative to k[0].  A
    single chunk takes one pass with no online-softmax carries.
    """
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    chunk = min(chunk, Sk)
    n_chunks = -(-Sk // chunk)  # the last chunk's pad keys are masked
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=dev)

    if n_chunks == 1:
        s = _chunk_scores(qg, k, scale)  # (B,KV,G,Sq,Sk)
        mask = _mask(q_pos, torch.arange(Sk, device=dev), Sk, causal, window)
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=dev))
        p = torch.softmax(s, dim=-1)
        o = _weighted_values(p, v)
        return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)

    m = torch.full((B, KV, G, Sq), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=dev)
    o = torch.zeros((B, KV, G, Sq, hd), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kb, vb = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        n = kb.shape[1]
        if n < chunk:  # pad the last chunk with zero keys, masked below
            pad = (0, 0, 0, 0, 0, chunk - n)
            kb = torch.nn.functional.pad(kb, pad)
            vb = torch.nn.functional.pad(vb, pad)
        s = _chunk_scores(qg, kb, scale)  # (B,KV,G,Sq,chunk)
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        mask = _mask(q_pos, k_pos, Sk, causal, window)
        s = torch.where(mask, s, torch.full((), _NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + _weighted_values(p, vb)
        m = m_new
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


def combine_partials(parts) -> torch.Tensor:
    """The softmax output from every block's ``(m, l, o)``
    (:func:`softmax_partial`), folded in the given (rank) order: the global
    max, then ``l = Σ l_r·exp(m_r − m)`` and ``o = Σ o_r·exp(m_r − m)``,
    then ``o / l``.  The same order on every rank gives the same bits."""
    top = parts[0][0]
    for m, _, _ in parts[1:]:
        top = torch.maximum(top, m)
    l_sum = o_sum = None
    for m, l, o in parts:
        w = torch.exp(m - top)
        l_sum = l * w if l_sum is None else l_sum + l * w
        o_sum = o * w[..., None] if o_sum is None else o_sum + o * w[..., None]
    return o_sum / torch.clamp(l_sum[..., None], min=1e-30)


def combine_over(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor, mesh,
                 axis: str = "model") -> torch.Tensor:
    """:func:`combine_partials` over the ranks of ``axis``: each rank's ``(m,
    l, o)`` all-gathered in one buffer (counted as ``softmax_combine``) and
    folded in coordinate order."""
    from repro_torch.launch.mesh import all_gather

    n = mesh.size(axis)
    packed = torch.cat([m[..., None], l[..., None], o], dim=-1)
    every = all_gather(packed[None], mesh, axis, dim=0, key="softmax_combine")
    return combine_partials([(every[r, ..., 0], every[r, ..., 1], every[r, ..., 2:])
                             for r in range(n)])


def _block(cache, mesh) -> tuple:
    """``(offset, global S)`` of the positions a cache's rank holds."""
    S = _seq(cache).shape[1]
    if cache.seq_shards == 1:
        return 0, S
    return mesh.index("model") * S, S * cache.seq_shards


def _seq(cache) -> torch.Tensor:
    return cache.k if isinstance(cache, KVCache) else cache.k_q


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    *,
    window: Optional[int] = None,
    mesh=None,
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd).  Masks positions ≥ ``cache.pos`` PER SLOT (and outside
    ``window``): slots sit at different depths under continuous batching.
    A sequence-sharded cache (``seq_shards`` > 1) takes every head of ``q``
    and combines the ranks' partials over ``mesh``'s ``model`` axis.  On
    the card the cache is read in place by K6
    (:mod:`repro_torch.kernels.decode_attention`), over each slot's rows only.
    """
    with trace.span("attn.decode", device=q.is_cuda):
        if cache.seq_shards == 1:
            return K6.attend(q, cache.k, cache.v, cache.pos, window=window)
        B, _, H, hd = q.shape
        off, _ = _block(cache, mesh)
        o = combine_over(*K6.attend(q, cache.k, cache.v, cache.pos, window=window,
                                    offset=off, partial=True), mesh)
        return o.reshape(B, 1, H, hd).to(q.dtype)


def _slot_insert(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
                 offset: int = 0, total: Optional[int] = None) -> torch.Tensor:
    """A copy of ``buf`` with ``new (B, T, ...)`` written at each slot's own
    position; the start clamps so the rows fit, as ``dynamic_update_slice``
    does (a dead slot's counter may run past the cache end).  ``buf`` may
    be a rank's block of ``total`` positions from ``offset`` on: only the
    rows that fall in it are written (the rest go to a scratch row that is
    dropped)."""
    B, T = new.shape[:2]
    S = buf.shape[1]
    total = S if total is None else total
    start = torch.clamp(pos.long(), 0, total - T)
    rows = start[:, None] + torch.arange(T, device=buf.device)  # (B, T)
    if total != S:
        rows = rows - offset
        rows = torch.where((rows >= 0) & (rows < S), rows, torch.full_like(rows, S))
        buf = torch.cat([buf, buf[:, :1]], dim=1)
    index = rows.reshape(B, T, *([1] * (new.ndim - 2))).expand_as(new)
    out = buf.scatter(1, index, new.to(buf.dtype))
    return out if total == S else out[:, :S]


def update_cache(
    cache: KVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    lengths: Optional[torch.Tensor] = None,
    mesh=None,
) -> KVCache:
    """Insert (B, T, KV, hd) at each slot's ``cache.pos`` (T=1 decode, T=S
    prefill).  ``lengths`` (B,) advances each counter by its REAL prompt
    length: right-padded prefill writes all T rows, but pad rows land at
    positions ≥ ``lengths[b]``, which decode never marks valid.  A
    sequence-sharded cache takes the whole ``k_new``/``v_new`` and keeps
    the rows of its rank's positions on ``mesh``."""
    adv = k_new.shape[1] if lengths is None else lengths.to(cache.pos.dtype)
    at = _block(cache, mesh)
    # a decode step writes one position and its write is timed on the device;
    # a prefill's is timed on the host only, since no reader uses its device time
    with trace.span("attn.kv_write", device=k_new.is_cuda and k_new.shape[1] == 1):
        return dataclasses.replace(
            cache,
            k=_slot_insert(cache.k, k_new, cache.pos, *at),
            v=_slot_insert(cache.v, v_new, cache.pos, *at),
            pos=cache.pos + adv,
        )


# ---------------------------------------------------------------------------
# PASM-quantized KV cache (beyond the paper): int8 storage, scales folded
# into the score/output contractions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QuantKVCache:
    k_q: torch.Tensor  # (B, S, KV, hd) int8
    v_q: torch.Tensor
    k_scale: torch.Tensor  # (B, S, KV) f32 — per token·head amax/127
    v_scale: torch.Tensor
    pos: torch.Tensor  # (B,) int32 — per slot
    seq_shards: int = 1  # ranks along ``model`` the positions split over


def init_quant_kv_cache(batch: int, seq: int, n_kv: int, hd: int, *,
                        device=None) -> QuantKVCache:
    return QuantKVCache(
        k_q=torch.zeros((batch, seq, n_kv, hd), dtype=torch.int8, device=device),
        v_q=torch.zeros((batch, seq, n_kv, hd), dtype=torch.int8, device=device),
        k_scale=torch.zeros((batch, seq, n_kv), dtype=torch.float32, device=device),
        v_scale=torch.zeros((batch, seq, n_kv), dtype=torch.float32, device=device),
        pos=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _quantize_kv(x: torch.Tensor) -> tuple:
    """(B, T, KV, hd) → int8 values + (B, T, KV) scales."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def update_quant_cache(cache: QuantKVCache, k_new, v_new, *,
                       lengths: Optional[torch.Tensor] = None, mesh=None) -> QuantKVCache:
    adv = k_new.shape[1] if lengths is None else lengths.to(cache.pos.dtype)
    at = _block(cache, mesh)
    with trace.span("attn.kv_write", device=k_new.is_cuda and k_new.shape[1] == 1):
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        return dataclasses.replace(
            cache,
            k_q=_slot_insert(cache.k_q, kq, cache.pos, *at),
            v_q=_slot_insert(cache.v_q, vq, cache.pos, *at),
            k_scale=_slot_insert(cache.k_scale, ks, cache.pos, *at),
            v_scale=_slot_insert(cache.v_scale, vs, cache.pos, *at),
            pos=cache.pos + adv,
        )


def decode_attention_quant(q: torch.Tensor, cache: QuantKVCache, *,
                           window: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Single-token attention over the int8 cache: ``k_scale`` folds into the
    scores after the contraction, ``v_scale`` into the softmax weights.  A
    sequence-sharded cache combines the ranks' partials, as
    :func:`decode_attention`."""
    B, _, H, hd = q.shape
    _, S, KV, _ = cache.k_q.shape
    G = H // KV
    scale = hd ** -0.5
    with trace.span("attn.decode", device=q.is_cuda):
        qg = q.reshape(B, KV, G, 1, hd).float()
        kq = cache.k_q.to(q.dtype).float().permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,S)
        s = matmul_f32(qg, kq)[:, :, :, 0]  # (B,KV,G,S)
        s = s * cache.k_scale.permute(0, 2, 1)[:, :, None, :] * scale
        off, _ = _block(cache, mesh)
        valid = valid_rows(cache.pos, S, window, off)
        s = torch.where(valid[:, None, None, :], s, torch.full((), _NEG_INF, device=q.device))
        if cache.seq_shards > 1:
            o = combine_over(*softmax_partial(s, cache.v_q, cache.v_scale.permute(0, 2, 1)[
                :, :, None, :]), mesh)
            return o.reshape(B, 1, H, hd).to(q.dtype)
        p = torch.softmax(s, dim=-1)
        pv = p * cache.v_scale.permute(0, 2, 1)[:, :, None, :]
        vq = cache.v_q.float().permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,S,hd)
        o = matmul_f32(pv[:, :, :, None], vq)[:, :, :, 0]
        return o.reshape(B, 1, H, hd).to(q.dtype)
