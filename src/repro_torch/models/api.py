"""Model API: family dispatch, input specs, loss — one surface for all archs.

Port of ``repro.models.api``: the transformer families (dense, MoE, VLM),
the SSM family, the RG-LRU hybrid, the audio encoder-decoder and the CNN.
Input specs are ``meta`` tensors: a shape and a dtype, no storage (the JAX
package's ``jax.ShapeDtypeStruct``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models.common import ShardCtx, local_rows

__all__ = ["get_model", "cache_len", "frontend_spec", "input_specs", "lm_loss",
           "sharded_lm_loss"]


def get_model(cfg):
    """The module implementing ``init_params``/``forward``/``init_caches``/
    ``prefill``/``decode_step`` for ``cfg``'s family.  Family ``cnn``
    (a ``CNNConfig``) exposes ``init_params``/``quantize``/``forward``."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models import transformer as m
    elif cfg.family == "ssm":
        from repro_torch.models import ssm_lm as m
    elif cfg.family == "hybrid":
        from repro_torch.models import hybrid as m
    elif cfg.family == "audio":
        from repro_torch.models import encdec as m
    elif cfg.family == "cnn":
        from repro_torch.models import cnn as m
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return m


def cache_len(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """KV-cache length for a serve cell (VLM prefill also stores the patch prefix)."""
    extra = cfg.frontend_tokens if cfg.frontend == "vit" else 0
    return shape.seq_len + extra


def _spec(shape: tuple, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_spec(cfg: ArchConfig, batch: int) -> Optional[torch.Tensor]:
    """The modality frontend's input, bf16: vit patch embeddings (stub)
    ``(B, frontend_tokens, frontend_dim)``, or log-mel frames ``(B, n_mels,
    2·frontend_tokens)`` into the stride-2 conv stem (encdec halves the time
    axis onto the ``frontend_tokens``-long encoder sequence); None without
    a frontend."""
    if cfg.frontend == "vit":
        return _spec((batch, cfg.frontend_tokens, cfg.frontend_dim), torch.bfloat16)
    if cfg.frontend == "audio":
        return _spec((batch, cfg.n_mels, 2 * cfg.frontend_tokens), torch.bfloat16)
    return None


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input of this cell.

    train/prefill: the full-length token batch (+ frontend embeds);
    decode: one new token (the caches come from ``init_caches(...,
    device="meta")``).
    """
    B = shape.global_batch
    if shape.kind == "train":
        d = {"tokens": _spec((B, shape.seq_len), torch.int32),
             "labels": _spec((B, shape.seq_len), torch.int32)}
    elif shape.kind == "prefill":
        d = {"tokens": _spec((B, shape.seq_len), torch.int32)}
    else:  # decode: one token against a seq_len cache
        d = {"tokens": _spec((B, 1), torch.int32)}
    fe = frontend_spec(cfg, B)
    if fe is not None and shape.kind != "decode":
        d["frontend_embeds"] = fe
    return d


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (labels already shifted by the pipeline)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels[..., None].long())[..., 0]
    if mask is None:
        mask = torch.ones_like(ll)
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sharded_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor], cfg: ArchConfig,
                    sctx: ShardCtx) -> torch.Tensor:
    """:func:`lm_loss` of the global logits, from this rank's block of them.

    Under an active ``sctx`` ``logits`` is what a family's ``forward(...,
    logits_block=True)`` returns: this rank's rows (when the batch splits
    over ``data``) by its ``V / model`` vocab columns, or by the whole
    vocab where the head is replicated; ``labels`` and ``mask`` are the
    global ones.  A vocab block takes the log-softmax over ``model``: the
    row max (no gradient: the result does not depend on it), the sums of
    ``exp(z - max)`` and the label's logit from the rank whose columns hold
    it, summed over ``model``.  The masked sum and the mask's count are
    summed over ``data``; the count is clamped to 1 after that sum.  The
    sums are the differentiable :func:`~repro_torch.launch.mesh.all_reduce`,
    whose backward is the identity, so a rank's gradient is its block of
    the global logits' gradient.  Nothing is reduced over an axis of one
    rank: at mesh ``(1, 1)`` (or inactive) this is :func:`lm_loss`, op for
    op.  Works in f32, as :func:`lm_loss` does."""
    if not sctx.active or (not sctx.batch_split and logits.shape[-1] == cfg.vocab):
        return lm_loss(logits, labels, mask)
    from repro_torch.launch.mesh import all_reduce, max_over

    mesh, model = sctx.mesh, sctx.model
    labels, mask = local_rows(labels, sctx), local_rows(mask, sctx)
    z = logits.float()
    if z.shape[-1] == cfg.vocab:  # a replicated head: this rank's rows, every column
        ll = torch.gather(torch.log_softmax(z, dim=-1), -1, labels[..., None].long())[..., 0]
    else:
        n = z.shape[-1]
        with torch.no_grad():
            m = max_over(z.amax(-1), mesh, (model,), key="lm_loss")
        loc = labels.long() - mesh.index(model) * n
        own = (loc >= 0) & (loc < n)
        zl = torch.gather(z, -1, torch.where(own, loc, torch.zeros_like(loc))[..., None])[..., 0]
        parts = torch.stack([torch.exp(z - m[..., None]).sum(-1),
                             torch.where(own, zl, torch.zeros_like(zl))], dim=-1)
        s, zl = all_reduce(parts, mesh, model, key="lm_loss").unbind(-1)
        ll = zl - m - torch.log(s)
    mask = torch.ones_like(ll) if mask is None else mask.float()
    num_den = torch.stack([-(ll * mask).sum(), mask.sum()])
    if sctx.batch_split:
        num_den = all_reduce(num_den, mesh, "data", key="lm_loss")
    num, den = num_den.unbind()
    return num / torch.clamp(den, min=1.0)
