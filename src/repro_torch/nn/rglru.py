"""RG-LRU recurrence (RecurrentGemma / Griffin, arXiv:2402.19427).

Port of ``repro.nn.rglru``::

  r_t = σ(x_t W_a + b_a)                        recurrence gate
  i_t = σ(x_t W_x + b_x)                        input gate
  a_t = exp(−c·softplus(Λ)·r_t)                 per-channel decay, c = 8
  h_t = a_t ⊙ h_{t-1} + √(1−a_t²) ⊙ (i_t ⊙ x_t)

Prefill runs the linear recurrence as a log-depth doubling scan over the
sequence (the JAX package's ``associative_scan``): ⌈log2 S⌉ steps of a few
elementwise ops on ``(a, b)`` pairs, no loop over tokens.  The closed form
``exp(cumsum(log a))`` is not used: ``log a`` reaches −8·softplus(4) ≈ −32
a step, so its inverse overflows within a few tokens.  Decode is a
one-step update.  The depthwise causal conv, shared with the SSM family,
runs in the input's dtype, each product and sum rounded as in the JAX
package; its decode step sums in f32.  The window carried into decode is
left-padded with the zeros the conv assumes before the first token, so a
prompt shorter than the conv decodes too.

Under a mesh (``models/hybrid.py``) every function runs on a rank's block
of the channels: the conv, its window, ``lam``/``b_a``/``b_x`` and the
state.  The gates read the whole conv output (``whole=``) through the
rank's column blocks of ``w_a``/``w_x`` (``linear=``, still ``dequant``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.nn import layers as L

__all__ = ["rg_lru_scan", "rg_lru_decode_step", "causal_conv1d", "conv1d_decode_step",
           "conv_window"]

_C = 8.0


def _gates(x: torch.Tensor, params: dict, whole=None, linear=None) -> tuple:
    """``(a, √(1−a²)·i·x)`` in f32.  ``w_a`` and ``w_x`` take the ``dequant``
    path whatever the model's impl (the JAX package's rule): no kernel.
    ``x`` may be a rank's channels; the gate matrices then read ``whole``
    (the whole input) through ``linear(input, w)``, their column blocks."""
    xin = x if whole is None else whole
    if linear is None:
        def linear(a, w):
            return L.linear(a, w, "dequant")
    r = torch.sigmoid(linear(xin, params["w_a"]) + params["b_a"].to(x.dtype))
    i = torch.sigmoid(linear(xin, params["w_x"]) + params["b_x"].to(x.dtype))
    log_a = -_C * F.softplus(params["lam"].float()) * r.float()
    a = torch.exp(log_a)
    gated = (i.float() * x.float()) * torch.sqrt(
        torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9))
    return a, gated


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t·h_{t-1} + b_t`` from ``h_{-1} = 0`` along axis 1, by
    doubling: after the step of span ``d`` each ``(a_t, b_t)`` composes the
    ``2d`` steps ending at ``t``."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rg_lru_scan(x: torch.Tensor, params: dict,
                init_h: torch.Tensor | None = None, *, whole=None, linear=None) -> tuple:
    """x: (B, S, W) → (y (B, S, W) in x's dtype, h_final (B, W) f32).
    ``whole``/``linear``: a rank's channels, as :func:`_gates`."""
    a, b = _gates(x, params, whole, linear)
    if init_h is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * init_h.float()[:, None], b[:, 1:]], dim=1)
    h = _linear_scan(a, b)
    return h.to(x.dtype), h[:, -1]


def rg_lru_decode_step(x: torch.Tensor, params: dict, h: torch.Tensor, *,
                       whole=None, linear=None) -> tuple:
    """x: (B, W) one token; h: (B, W) carried state.  ``whole`` (B, W) /
    ``linear``: a rank's channels, as :func:`_gates`."""
    a, b = _gates(x[:, None, :], params, None if whole is None else whole[:, None, :],
                  linear)
    h_new = a[:, 0] * h.float() + b[:, 0]
    return h_new.to(x.dtype), h_new


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x (B, S, W); w (K, W); left-padded, no lookahead."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    wd = w.to(x.dtype)
    y = sum(xp[:, k:k + S] * wd[k] for k in range(K))
    return y + b.to(x.dtype)


def conv_window(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width − 1`` conv inputs of ``x (B, S, W)``, left-padded
    with zeros when ``S < width − 1``: what decode carries."""
    return F.pad(x, (0, 0, width - 1, 0))[:, -(width - 1):]


def conv1d_decode_step(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       window: torch.Tensor) -> tuple:
    """One-token depthwise conv.  window (B, K-1, W) holds the last K-1 inputs."""
    full = torch.cat([window, x[:, None, :].to(window.dtype)], dim=1)  # (B, K, W)
    y = (full.float() * w.float()[None]).sum(dim=1) + b.float()
    return y.to(x.dtype), full[:, 1:]
