"""Model API: family dispatch, cache length, loss — one surface for all archs.

Port of ``repro.models.api``.  The dense transformer family and the CNN are
ported; the MoE, VLM, SSM, hybrid and audio families raise
``NotImplementedError`` naming ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import NOT_PORTED_FAMILY
from repro_torch.configs.base import ArchConfig, ShapeSpec

__all__ = ["get_model", "cache_len", "lm_loss"]

_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio", "cnn")


def get_model(cfg):
    """The module implementing ``init_params``/``forward``/``init_caches``/
    ``prefill``/``decode_step`` for ``cfg``'s family.  Family ``cnn``
    (a ``CNNConfig``) exposes ``init_params``/``quantize``/``forward``."""
    if cfg.family == "dense":
        from repro_torch.models import transformer as m
    elif cfg.family == "cnn":
        from repro_torch.models import cnn as m
    elif cfg.family in _FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED_FAMILY}")
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return m


def cache_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """KV-cache length for a serve cell (VLM prefill also stores the patch prefix)."""
    extra = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    return shape.seq_len + extra


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (labels already shifted by the pipeline)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
