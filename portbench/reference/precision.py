"""Operand roundings for the controls: the reference computed one precision
below what a configuration states, to show that the comparison fails it.

Each is a function applied to both operands of every product; the sum stays
in f32, as on the hardware that offers the lower precision.
"""
from __future__ import annotations

import torch

__all__ = ["ROUNDINGS", "tf32", "fp8"]

FP8_MAX = 448.0  # float8_e4m3fn's largest finite value


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to TF32's 10 mantissa bits, to nearest even (the tensor
    cores' input rounding), on any device."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 under one scale for the whole tensor (its largest
    magnitude mapped to 448), back in f32."""
    x = x.float()
    s = x.abs().amax().clamp(min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).float() * s


ROUNDINGS = {"tf32": tf32, "fp8": fp8}
