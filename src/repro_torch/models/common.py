"""Model init helpers on an explicit ``torch.Generator``.

Port of ``repro.models.common``'s ``trunc_normal`` / ``Initializer``.  The
two packages draw different numbers from the same seed; the tests carry
weights across with :mod:`repro_torch.interop` instead.
"""
from __future__ import annotations

import torch

__all__ = ["trunc_normal", "Initializer"]


def trunc_normal(gen: torch.Generator, shape, std, dtype=torch.float32) -> torch.Tensor:
    """Standard normal truncated to ``[-2, 2]``, times ``std``, drawn on the
    generator's device."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t * std).to(dtype)


class Initializer:
    """Draws every init from one generator, so init code reads linearly."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def dense(self, shape, fan_in=None, dtype=torch.float32) -> torch.Tensor:
        fan_in = fan_in or shape[0]
        return trunc_normal(self.gen, shape, fan_in ** -0.5, dtype)
