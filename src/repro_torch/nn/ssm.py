"""Mamba-2 SSD (state-space duality): chunked scan, training + decode.

Port of ``repro.nn.ssm``.  The selective SSM
``h_t = exp(dt_t·A) h_{t-1} + dt_t·B_t ⊗ x_t``, ``y_t = C_t·h_t + D·x_t``
(Dao & Gu 2024, arXiv:2405.21060), computed chunk-parallel: attention-like
products inside chunks of length Q, a linear state recurrence across
chunks (a loop over the S/Q chunks).  A sequence that is not a multiple of
the chunk is padded with ``dt = 0`` steps, which keep the state and add
nothing, so both packages sum in the same blocks.  Every product runs in
f32 with TF32 off.

Shapes: x (B, S, H, P) heads × head_dim; B/C (B, S, G, N) groups × state;
dt (B, S, H); A (H,) negative reals.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core._f32 import einsum_f32

__all__ = ["ssd_scan", "ssd_decode_step", "SSMState"]


@dataclasses.dataclass
class SSMState:
    h: torch.Tensor  # (B, H, P, N)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 128,
    init_state: torch.Tensor | None = None,
) -> tuple:
    """Chunked SSD.  Returns (y (B, S, H, P) in x's dtype, final_state
    (B, H, P, N) f32)."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    S_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
        S = S + pad
    nc = S // chunk
    rep = H // G  # heads per B/C group

    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bc = Bm.reshape(Bsz, nc, chunk, G, N).float()
    Cc = Cm.reshape(Bsz, nc, chunk, G, N).float()

    dA = dtc * A.float()  # (B,nc,Q,H) ≤ 0
    cum = torch.cumsum(dA, dim=2)  # within-chunk cumulative log-decay
    seg_end = cum[:, :, -1, :]  # (B,nc,H)

    # intra-chunk: L[t,s] = exp(cum_t − cum_s) for s ≤ t (log space).  The
    # mask goes inside the exp: above the diagonal cum_t − cum_s > 0 and its
    # exp can overflow, whose backward (0 · inf) would be NaN; the forward
    # is the same bits
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(tri[None, None, :, :, None], diff, -torch.inf))
    cb = einsum_f32("bctgn,bcsgn->bctsg", Cc, Bc)
    cb = torch.repeat_interleave(cb, rep, dim=-1)  # (B,nc,t,s,H)
    w = cb * Lmat * dtc[:, :, None, :, :]  # weight on x_s
    y_intra = einsum_f32("bctsh,bcshp->bcthp", w, xc)

    # chunk states: Σ_s exp(seg_end − cum_s)·dt_s·B_s ⊗ x_s
    decay_to_end = torch.exp(seg_end[:, :, None, :] - cum) * dtc  # (B,nc,Q,H)
    BxH = torch.repeat_interleave(Bc, rep, dim=3)  # (B,nc,Q,H,N)
    states = einsum_f32("bcsh,bcshn,bcshp->bchpn", decay_to_end, BxH, xc)

    # inter-chunk recurrence: the state entering each chunk
    h = (init_state.float() if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device))
    enter = []
    for c in range(nc):
        enter.append(h)
        h = h * torch.exp(seg_end[:, c])[:, :, None, None] + states[:, c]
    h_enter = torch.stack(enter, dim=1)  # (B,nc,H,P,N)

    # inter-chunk contribution: y_t += C_t · exp(cum_t) · h_enter
    CH = torch.repeat_interleave(Cc, rep, dim=3)  # (B,nc,Q,H,N)
    y_inter = einsum_f32("bcthn,bchpn->bcthp", CH * torch.exp(cum)[..., None], h_enter)

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    y = y + x.float() * D.float()[None, None, :, None]
    return y[:, :S_orig].to(x.dtype), h


def ssd_decode_step(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    state: torch.Tensor,
) -> tuple:
    """One-token SSD update.  x (B,H,P); dt (B,H); B/C (B,G,N); state (B,H,P,N)."""
    H, G = x.shape[1], Bm.shape[1]
    rep = H // G
    dtf = dt.float()
    dA = torch.exp(dtf * A.float()[None, :])  # (B,H)
    BH = torch.repeat_interleave(Bm, rep, dim=1).float()  # (B,H,N)
    CH = torch.repeat_interleave(Cm, rep, dim=1).float()
    xf = x.float()
    new_state = state * dA[:, :, None, None] + \
        (dtf[:, :, None, None] * xf[:, :, :, None]) * BH[:, :, None, :]
    y = einsum_f32("bhpn,bhn->bhp", new_state, CH) + xf * D.float()[None, :, None]
    return y.to(x.dtype), new_state
