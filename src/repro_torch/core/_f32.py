"""Full-float32 matrix products for the plain paths.

A float32 ``torch.matmul`` on the card may run in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set, which keeps about three
decimal digits.  The port's plain versions are the oracles the kernels are
held against, so every product they take runs with TF32 off; the flag is
restored afterwards so callers' own settings survive.
"""
from __future__ import annotations

import torch

__all__ = ["matmul_f32", "widened_matmul", "einsum_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 disabled for the duration of the product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Widened(torch.autograd.Function):
    """``a.float() @ b.float()`` for a 2-D ``b``, keeping ``a`` and ``b`` as
    given for the backward, which widens them again (exact) and takes the
    products autograd takes for the folded ``mm``: the same gradients,
    bitwise, without holding the f32 copy of a bf16 ``a`` (twice its
    bytes) from the forward to the backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul_f32(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        K, N = b.shape
        g2 = g.reshape(-1, N)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = matmul_f32(g2, b.float().t()).reshape(a.shape).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = matmul_f32(a.float().reshape(-1, K).t(), g2).to(b.dtype)
        return ga, gb


def widened_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``matmul_f32(a.float(), b.float())``; differentiated with a 2-D ``b``,
    the f32 copies are made again in the backward instead of kept
    (:class:`_Widened`)."""
    if b.ndim == 2 and torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _Widened.apply(a, b)
    return matmul_f32(a.float(), b.float())


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with TF32 disabled for the duration of the product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum(eq, *operands)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
