"""Shared layers: linear (PASM-aware), norms, activations, RoPE.

Port of ``repro.nn.layers``.  Every weight-bearing op goes through
:func:`linear`, a thin alias of :func:`repro_torch.core.params.matmul` — one
dispatch table (dense | shared | int4-packed | grouped × dequant | kernel |
pas_kernel, with the fused bias/ReLU epilogue).  The norms compute in f32
and return the input's dtype, as the JAX package's do.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import params as _params

Weight = _params.Weight

__all__ = [
    "linear",
    "rms_norm",
    "layer_norm",
    "swiglu",
    "sq_relu",
    "gelu_ffn_act",
    "rope",
    "apply_rope",
]


def linear(
    x: torch.Tensor,
    w: Weight,
    impl: str = "dense",
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    mesh=None,
) -> torch.Tensor:
    """``x @ w`` where ``w`` is dense or weight-shared (a ``PasmParams``).

    ``impl`` (for quantized leaves): ``"dequant"`` | ``"kernel"`` |
    ``"pas_kernel"``; plain tensors and dense params always take the dense
    product.  ``mesh=`` shards the kernel paths as
    :func:`repro_torch.core.params.matmul` does.  The output dtype follows
    ``x``.
    """
    return _params.matmul(x, w, impl=impl, bias=bias, relu=relu, mesh=mesh)


def _rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in the ``1 + scale`` form (zero-initialised scales).

    Differentiated, it keeps only its inputs and recomputes itself in the
    backward (``torch.utils.checkpoint``): the same ops, so the same bits,
    without holding two f32 copies of a bf16 ``x`` (four times its bytes)
    until then."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        from torch.utils.checkpoint import checkpoint

        return checkpoint(_rms_norm, x, scale, eps, use_reentrant=False,
                          preserve_rng_state=False)
    return _rms_norm(x, scale, eps)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor], eps: float = 1e-5
) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(dt)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def sq_relu(x: torch.Tensor) -> torch.Tensor:
    """Squared ReLU (Nemotron-4)."""
    r = torch.clamp(x, min=0)
    return r * r


def gelu_ffn_act(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def rope(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables for ``positions`` (any shape) → ``(..., head_dim/2)``."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: ``(..., seq, heads, head_dim)``; cos/sin: ``(..., seq, head_dim/2)``.
    Computed in f32 (the tables' dtype), returned in ``x``'s dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over the heads axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
