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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core._f32 import matmul_f32

__all__ = [
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


def _valid(pos: torch.Tensor, S: int, window: Optional[int]) -> torch.Tensor:
    """(B, S): cache rows each slot may read (below its own position)."""
    k_pos = torch.arange(S, device=pos.device)
    valid = k_pos[None, :] < pos[:, None]
    if window is not None:
        valid = valid & (k_pos[None, :] >= pos[:, None] - window)
    return valid


def decode_attention(
    q: torch.Tensor,
    cache: KVCache,
    *,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Single-token attention against a KV cache.

    q: (B, 1, H, hd).  Masks positions ≥ ``cache.pos`` PER SLOT (and outside
    ``window``): slots sit at different depths under continuous batching.
    """
    B, _, H, hd = q.shape
    _, S, KV, _ = cache.k.shape
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, 1, hd).float()
    kt = cache.k.permute(0, 2, 3, 1).float()[:, :, None]  # (B,KV,1,hd,S)
    s = matmul_f32(qg, kt)[:, :, :, 0] * scale  # (B,KV,G,S)
    valid = _valid(cache.pos, S, window)
    s = torch.where(valid[:, None, None, :], s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    vt = cache.v.permute(0, 2, 1, 3).float()[:, :, None]  # (B,KV,1,S,hd)
    o = matmul_f32(p.to(cache.v.dtype).float()[:, :, :, None], vt)[:, :, :, 0]
    return o.reshape(B, 1, H, hd).to(q.dtype)


def _slot_insert(buf: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """A copy of ``buf`` with ``new (B, T, ...)`` written at each slot's own
    position; the start clamps so the rows fit, as ``dynamic_update_slice``
    does (a dead slot's counter may run past the cache end)."""
    B, T = new.shape[:2]
    S = buf.shape[1]
    start = torch.clamp(pos.long(), 0, S - T)
    rows = start[:, None] + torch.arange(T, device=buf.device)  # (B, T)
    index = rows.reshape(B, T, *([1] * (new.ndim - 2))).expand_as(new)
    return buf.scatter(1, index, new.to(buf.dtype))


def update_cache(
    cache: KVCache,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    *,
    lengths: Optional[torch.Tensor] = None,
) -> KVCache:
    """Insert (B, T, KV, hd) at each slot's ``cache.pos`` (T=1 decode, T=S
    prefill).  ``lengths`` (B,) advances each counter by its REAL prompt
    length: right-padded prefill writes all T rows, but pad rows land at
    positions ≥ ``lengths[b]``, which decode never marks valid."""
    adv = k_new.shape[1] if lengths is None else lengths.to(cache.pos.dtype)
    return KVCache(
        k=_slot_insert(cache.k, k_new, cache.pos),
        v=_slot_insert(cache.v, v_new, cache.pos),
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
                       lengths: Optional[torch.Tensor] = None) -> QuantKVCache:
    kq, ks = _quantize_kv(k_new)
    vq, vs = _quantize_kv(v_new)
    adv = k_new.shape[1] if lengths is None else lengths.to(cache.pos.dtype)
    return QuantKVCache(
        k_q=_slot_insert(cache.k_q, kq, cache.pos),
        v_q=_slot_insert(cache.v_q, vq, cache.pos),
        k_scale=_slot_insert(cache.k_scale, ks, cache.pos),
        v_scale=_slot_insert(cache.v_scale, vs, cache.pos),
        pos=cache.pos + adv,
    )


def decode_attention_quant(q: torch.Tensor, cache: QuantKVCache, *,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token attention over the int8 cache: ``k_scale`` folds into the
    scores after the contraction, ``v_scale`` into the softmax weights."""
    B, _, H, hd = q.shape
    _, S, KV, _ = cache.k_q.shape
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, 1, hd).float()
    kq = cache.k_q.to(q.dtype).float().permute(0, 2, 3, 1)[:, :, None]  # (B,KV,1,hd,S)
    s = matmul_f32(qg, kq)[:, :, :, 0]  # (B,KV,G,S)
    s = s * cache.k_scale.permute(0, 2, 1)[:, :, None, :] * scale
    valid = _valid(cache.pos, S, window)
    s = torch.where(valid[:, None, None, :], s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    pv = p * cache.v_scale.permute(0, 2, 1)[:, :, None, :]
    vq = cache.v_q.float().permute(0, 2, 1, 3)[:, :, None]  # (B,KV,1,S,hd)
    o = matmul_f32(pv[:, :, :, None], vq)[:, :, :, 0]
    return o.reshape(B, 1, H, hd).to(q.dtype)
