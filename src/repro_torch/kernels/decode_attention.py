"""K6: split-KV decode attention on Hopper, and its plain version.

K6 replaces no TPU kernel: the JAX package decodes with an XLA ``einsum``
(``repro/nn/attention.py::decode_attention``, ``preferred_element_type=f32``).
It was added because the plain version of that arithmetic — the whole K and V
caches widened to f32 through a permuted copy, every position scored whatever
the slot's ``pos``, two f32 ``gemv``, the mask applied afterwards — took 87 %
of a phi3-medium decode tick on an H100.

One query token a slot, ``q (B, 1, H, hd)``, attends to a cache ``k, v (B, S,
KV, hd)`` with ``H = KV·G``.  Slot ``b`` reads the rows ``offset + j <
pos[b]`` (and ``offset + j >= pos[b] - window`` with a ``window``); ``offset``
is where a sequence-sharded cache's block of positions starts.  A slot with
no such row reads every row scored ``-1e30``, as the plain softmax over
all-masked scores does.  Scores are ``q·k`` in f32 from exact widenings
times ``hd ** -0.5``, the softmax f32, the weights rounded to ``v``'s dtype
before the value product, the sums f32, the output in ``q``'s dtype; with
``partial`` the block's f32 ``(m, l, o)`` (:func:`softmax_partial`) instead,
for :func:`repro_torch.nn.attention.combine_over` to fold over the ranks.

:func:`decode_attention_kernel_call` launches ``csrc/decode_attention.cu``:
it reads the bf16 or f32 cache where it lies (each slot's ``(S, KV, hd)``
rows row-major, any batch stride), only the rows a slot may read, in splits
of :data:`CHUNK` positions folded in split order (no atomics: a call repeats
bit for bit).  Its weights are rounded relative to their split's running
max, so the bf16 cache is held to :func:`decode_attention_plain` with
``|Δ| ≤ 2^-7·(|plain| + Σ_j p_j·|v_j|)`` (:data:`BF16_TOL`, K5's form), the
f32 cache within ``1e-5``.  Head dims: :data:`HEAD_DIMS`; query heads a KV
head: 1 to :data:`MAX_GROUP`.  The host never reads ``pos``.

:func:`attend` is the wrapper: on CUDA tensors it launches K6 or raises; on
any other (the CPU, the dry run's meta tensors) it runs
:func:`decode_attention_plain`.
Each launch adds one to ``launches["decode_attention"]`` (the counter dict
of :mod:`repro_torch.kernels.pasm_matmul`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core._f32 import matmul_f32
from repro_torch.kernels.flash_attention import BF16_TOL, HEAD_DIMS
from repro_torch.kernels.pasm_matmul import _on, _raise_on, _stream, launches

__all__ = ["attend", "decode_attention_kernel_call", "decode_attention_plain",
           "softmax_partial", "valid_rows", "BF16_TOL", "CHUNK", "HEAD_DIMS",
           "MAX_GROUP"]

CHUNK = 256  # cache positions a split covers (csrc da::CHUNK)
MAX_GROUP = 16  # query heads one block serves (csrc da::MAX_G)
DTYPES = (torch.float32, torch.bfloat16)
_NEG_INF = -1e30


def valid_rows(pos: torch.Tensor, S: int, window: Optional[int],
               offset: int = 0) -> torch.Tensor:
    """(B, S): cache rows each slot may read (below its own position), the
    rows from ``offset`` on of a sequence-sharded cache."""
    k_pos = offset + torch.arange(S, device=pos.device)
    valid = k_pos[None, :] < pos[:, None]
    if window is not None:
        valid = valid & (k_pos[None, :] >= pos[:, None] - window)
    return valid


def softmax_partial(s: torch.Tensor, v: torch.Tensor,
                    v_scale: Optional[torch.Tensor] = None) -> tuple:
    """One block's share of a decode softmax: ``s (B, KV, G, S_b)`` f32
    scores (masked entries at ``-1e30``) and the block's values ``v (B,
    S_b, KV, hd)`` → ``(m, l, o)``, the block's max, its sum of ``exp(s −
    m)`` and its unnormalised output, all f32.  The weights are rounded to
    ``v``'s dtype before the value product, as the unsharded softmax's
    are; an int8 block folds ``v_scale (B, KV, 1, S_b)`` into them
    instead.  A block with no valid entry gives ``m = -1e30``, which
    :func:`repro_torch.nn.attention.combine_partials` weighs by zero."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]  # (B,KV,1,S_b,hd)
    w = p.to(v.dtype).float() if v_scale is None else p * v_scale
    o = matmul_f32(w[:, :, :, None], vt)[:, :, :, 0]  # (B,KV,G,hd)
    return m, l, o


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           pos: torch.Tensor, *, window: Optional[int] = None,
                           offset: int = 0, partial: bool = False):
    """K6's plain version: every position scored from the f32 widening of
    the whole cache, masked afterwards, softmaxed, times ``v`` in f32."""
    B, _, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, KV, G, 1, hd).float()
    kt = k.permute(0, 2, 3, 1).float()[:, :, None]  # (B,KV,1,hd,S)
    s = matmul_f32(qg, kt)[:, :, :, 0] * scale  # (B,KV,G,S)
    valid = valid_rows(pos, S, window, offset)
    s = torch.where(valid[:, None, None, :], s, torch.full((), _NEG_INF, device=q.device))
    if partial:
        return softmax_partial(s, v)
    p = torch.softmax(s, dim=-1)
    vt = v.permute(0, 2, 1, 3).float()[:, :, None]  # (B,KV,1,S,hd)
    o = matmul_f32(p.to(v.dtype).float()[:, :, :, None], vt)[:, :, :, 0]
    return o.reshape(B, 1, H, hd).to(q.dtype)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _check(q, k, v, pos) -> None:
    """Raise on what K6 does not take (shapes, dtypes, head dim, group,
    layout), before any device test."""
    if q.ndim != 4 or q.shape[1] != 1 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B,1,H,hd), k = v (B,S,KV,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, _, H, hd = q.shape
    _, S, KV, _ = k.shape
    if B == 0 or S == 0:
        raise ValueError(f"an empty call (B={B}, S={S})")
    if k.shape[0] != B or k.shape[3] != hd or pos.shape != (B,):
        raise ValueError(f"k {tuple(k.shape)}, pos {tuple(pos.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"q and the cache must be in {DTYPES} (k and v alike), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    if KV == 0 or H % KV or not 1 <= H // KV <= MAX_GROUP:
        raise ValueError(f"{H} query heads over {KV} KV heads: the kernel takes "
                         f"1 to {MAX_GROUP} whole query heads a KV head")
    rows = ((S, KV * hd), (KV, hd), (hd, 1))  # (size, stride) of a slot's dims
    for name, t in (("k", k), ("v", v)):
        if (any(n > 1 and st != want for (n, want), st in zip(rows, t.stride()[1:]))
                or t.data_ptr() % 16 or B > 1 and t.stride(0) * t.element_size() % 16):
            raise ValueError(
                f"{name} {tuple(t.shape)} with strides {t.stride()}: the kernel reads "
                "each slot's (S, KV, hd) rows row-major on 16-byte boundaries")
    if -(-S // CHUNK) > 65535:
        raise ValueError(f"S={S}: at most {65535 * CHUNK} cache positions")


def decode_attention_kernel_call(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 pos: torch.Tensor, *, window: Optional[int] = None,
                                 offset: int = 0, partial: bool = False):
    """K6: ``q (B, 1, H, hd)`` against ``k, v (B, S, KV, hd)`` on the card →
    ``(B, 1, H, hd)`` in ``q``'s dtype, or with ``partial`` the f32 ``(m, l,
    o)`` of :func:`softmax_partial` (``(B, KV, G)``, ``(B, KV, G)``, ``(B, KV,
    G, hd)``, views of one ``[m, l, o]`` buffer)."""
    _check(q, k, v, pos)
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError("the decode-attention kernel is forward-only; call under "
                           "torch.no_grad() or detach the inputs")
    if q.device.type != "cuda" or len({t.device for t in (q, k, v, pos)}) != 1:
        raise ValueError(f"the decode-attention kernel takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}, {pos.device} "
                         "(on the CPU, decode_attention_plain)")
    B, _, H, hd = q.shape
    _, S, KV, _ = k.shape
    G = H // KV
    out = (torch.empty((B, KV, G, hd + 2), dtype=torch.float32, device=q.device)
           if partial else torch.empty_like(q, memory_format=torch.contiguous_format))
    qc = q.contiguous()
    n_split = -(-S // CHUNK)
    part = torch.empty(B * KV * n_split * G * (hd + 2), dtype=torch.float32,
                       device=q.device)
    from repro_torch.kernels import _build

    fn = _build.entry_point("decode_attention", "decode_attention_launch",
                            [_P, _I, _P, _P, _L, _L, _I, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _L, _I, ctypes.c_float, _P])
    win = -1 if window is None else min(int(window), 2**31 - 1)
    with _on(q.device):
        err = fn(qc.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
                 v.data_ptr(), k.stride(0), v.stride(0), int(k.dtype == torch.bfloat16),
                 pos.data_ptr(), out.data_ptr(), part.data_ptr(), B, S, KV, G, hd,
                 win, int(offset), int(partial), hd ** -0.5, _stream(q.device))
    _raise_on(err, "decode_attention")
    launches["decode_attention"] += 1
    return (out[..., 0], out[..., 1], out[..., 2:]) if partial else out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor, *,
           window: Optional[int] = None, offset: int = 0, partial: bool = False):
    """Decode attention: K6 (:func:`decode_attention_kernel_call`) on CUDA
    tensors, which launches or raises; :func:`decode_attention_plain` on any
    other (the CPU, and the dry run's meta tensors, whose ops it counts)."""
    if q.device.type == "cuda":
        return decode_attention_kernel_call(q, k, v, pos, window=window, offset=offset,
                                            partial=partial)
    return decode_attention_plain(q, k, v, pos, window=window, offset=offset,
                                  partial=partial)
