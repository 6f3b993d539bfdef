"""The PASM identity: accumulate-into-bins first, multiply once per bin after.

Port of ``repro.core.pas``, the paper-faithful algorithmic core.  A
weight-shared MAC computes ``result = Σ_k x[k]·codebook[idx[k]]`` directly
(one multiply per element).  PASM (paper §2.2) re-orders it into two phases:

  PAS phase   ``S[b] = Σ_{k : idx[k] = b} x[k]``      (adds only — the
              "weighted histogram of the dictionary weight indices")
  post-pass   ``result = Σ_b S[b]·codebook[b]``       (B multiplies total)

The results are identical (bit-exact in integer arithmetic, equal up to
float reassociation otherwise) — paper §5.3.  These are plain tensor
functions; the kernels that run the two phases on the card are K3/K4
(:mod:`repro_torch.kernels.pas_histogram`).  Every float32 product runs with
TF32 off.
"""
from __future__ import annotations

import torch

from repro_torch.core import pasm as _pasm
from repro_torch.core._f32 import matmul_f32

__all__ = [
    "pas_accumulate",
    "pas_postpass",
    "pasm_dot",
    "weight_shared_dot",
    "pasm_matmul",
    "weight_shared_matmul",
    "pasm_cycles",
    "mac_cycles",
]


# ---------------------------------------------------------------------------
# 1-D (single output) — the paper's Fig 4 / Fig 6 setting
# ---------------------------------------------------------------------------


def pas_accumulate(x: torch.Tensor, idx: torch.Tensor, bins: int) -> torch.Tensor:
    """PAS phase: bin-accumulate ``x`` keyed by weight index (paper Fig 6a).

    Returns ``S`` with ``S[b] = Σ_{k : idx[k]=b} x[k]``.  Pure adds.  An
    index outside ``[0, bins)`` adds nothing, as ``jax.ops.segment_sum``
    drops it.
    """
    idx = idx.long()
    keep = (idx >= 0) & (idx < bins)
    out = torch.zeros(bins, dtype=x.dtype, device=x.device)
    return out.index_add_(0, idx[keep], x[keep])


def pas_postpass(bins_acc: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Post-pass multiply phase (paper Fig 6b): ``Σ_b S[b]·codebook[b]``."""
    return torch.dot(bins_acc, codebook)


def pasm_dot(x: torch.Tensor, idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Full PASM: PAS accumulate then shared post-pass MAC."""
    return pas_postpass(pas_accumulate(x, idx, codebook.shape[-1]), codebook)


def weight_shared_dot(x: torch.Tensor, idx: torch.Tensor,
                      codebook: torch.Tensor) -> torch.Tensor:
    """Baseline weight-shared MAC (paper Fig 3/4): dereference then MAC."""
    return torch.dot(x, codebook[idx.long()])


# ---------------------------------------------------------------------------
# 2-D (matmul) — PASM generalized to a GEMM with per-(k,n) indices
# ---------------------------------------------------------------------------


def pasm_matmul(x: torch.Tensor, t: _pasm.PASMTensor,
                dtype=torch.float32) -> torch.Tensor:
    """``x (…, K) @ shared-weight (K, N)`` via the PASM two-phase formulation.

    ``S[m,g,n,b] = Σ_k x[m,g,k]·[idx[g,k,n]=b]`` then
    ``y[m,n] = Σ_{g,b} S[m,g,n,b]·cb[g,b]``.  Grouped codebooks
    bin-accumulate within each group independently.
    """
    idx = _pasm.logical_idx(t)
    K, N = t.shape
    G, B = t.codebook.shape
    lead = x.shape[:-1]
    xg = x.to(dtype).reshape(-1, G, K // G).transpose(0, 1)  # (G, M, Kg)
    bins = torch.arange(B, device=idx.device)
    onehot = (idx.reshape(G, K // G, N)[..., None].long() == bins).to(dtype)
    # one-hot (G, Kg, N·B) contracted with x over Kg: the PAS phase
    s = matmul_f32(xg, onehot.reshape(G, K // G, N * B))  # (G, M, N·B)
    s = s.reshape(G, -1, N, B)
    # post-pass: Σ over groups and bins of S·cb
    y = matmul_f32(s.permute(1, 2, 0, 3).reshape(-1, N, G * B),
                   t.codebook.to(dtype).reshape(G * B))
    return y.reshape(*lead, N)


def weight_shared_matmul(x: torch.Tensor, t: _pasm.PASMTensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Baseline: dequantize (dictionary lookup) then ordinary GEMM."""
    w = _pasm.dequantize(t, dtype=dtype)
    return matmul_f32(x.to(dtype), w)


# ---------------------------------------------------------------------------
# cycle model (paper §2.2 / §4): N vs N + P·B
# ---------------------------------------------------------------------------


def mac_cycles(n_inputs: int) -> int:
    """Fully-pipelined MAC latency: one pair per cycle → ≈ N cycles."""
    return n_inputs


def pasm_cycles(n_inputs: int, bins: int, pas_per_mac: int = 1) -> int:
    """PASM latency: N-cycle PAS phase + post-pass of B per PAS sharing a MAC.

    Paper example (§2.2): N=1024, B=16, 4 PAS / shared MAC → 1024 + 4·16 = 1088.
    """
    return n_inputs + pas_per_mac * bins
