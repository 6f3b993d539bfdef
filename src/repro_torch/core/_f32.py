"""Full-float32 matrix products for the plain paths.

A float32 ``torch.matmul`` on the card may run in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set, which keeps about three
decimal digits.  The port's plain versions are the oracles the kernels are
held against, so every product they take runs with TF32 off; the flag is
restored afterwards so callers' own settings survive.
"""
from __future__ import annotations

import torch

__all__ = ["matmul_f32", "einsum_f32"]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with TF32 disabled for the duration of the product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def einsum_f32(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with TF32 disabled for the duration of the product."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum(eq, *operands)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
