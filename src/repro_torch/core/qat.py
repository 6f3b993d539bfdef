"""Quantization-aware training with weight-sharing.

Port of ``repro.core.qat``.  The forward snaps each dense master weight to
its nearest codebook entry; the backward passes the gradient straight
through to the master and gives each codebook entry the sum of the
gradients of the weights assigned to it (the PAS bin-accumulate applied to
the backward pass).

The per-bin sums are :func:`bin_sums`: one masked sum per bin, a fixed
reduction order on every device, so training stays bitwise reproducible
under ``torch.use_deterministic_algorithms`` (``bincount`` with weights
raises there on CUDA, and ``index_add_`` / ``scatter_add_`` sort every
index first).

Under a mesh a rank snaps its block of the masters (``cnn.qat_apply`` on
placed ``c_out`` blocks) onto the whole dictionary, so an entry's gradient
here is the bin sums of that block; the sharded train step adds the
blocks' sums over ``model`` (``models/sharding.py::grad_reduce_axes``).
"""
from __future__ import annotations

import torch

__all__ = ["assign_bins", "ste_quantize", "codebook_grads", "bin_sums"]


def assign_bins(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-entry bin assignment, any weight shape, ``(B,)`` codebook.

    The single-dictionary assignment rule: :func:`ste_quantize`'s forward
    and the conv stack's ``qat_requantize`` freeze both apply this argmin
    (ties go to the lower bin), so a trained master re-assigns identically.
    """
    return torch.argmin((w[..., None] - codebook).abs(), dim=-1)


def bin_sums(values: torch.Tensor, idx: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-bin sums over every dim but the first: ``(G, …)`` values and
    indices → ``(G, bins)``, entry ``[g, b]`` the sum of ``values[g]``
    where ``idx[g] == b``."""
    dims = tuple(range(1, values.ndim))
    zero = torch.zeros((), dtype=values.dtype, device=values.device)
    return torch.stack([torch.where(idx == b, values, zero).sum(dim=dims)
                        for b in range(bins)], dim=-1)


class _SteQuantize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, codebook):
        idx = assign_bins(w, codebook)
        ctx.save_for_backward(idx)
        ctx.bins = codebook.shape[0]
        return codebook[idx]

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        gcb = bin_sums(g.reshape(1, -1), idx.reshape(1, -1), ctx.bins)[0]
        return g, gcb


def ste_quantize(w: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Snap each weight to its nearest codebook entry; identity gradient to
    ``w``, bin-summed gradient to ``codebook``."""
    return _SteQuantize.apply(w, codebook)


def codebook_grads(w: torch.Tensor, codebook: torch.Tensor,
                   g: torch.Tensor) -> torch.Tensor:
    """Explicit codebook gradient (for tests): Σ_b-binned upstream grads."""
    idx = assign_bins(w, codebook)
    return bin_sums(g.reshape(1, -1), idx.reshape(1, -1), codebook.shape[0])[0]
