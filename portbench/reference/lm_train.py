"""The dense transformer's first training steps in plain PyTorch, f32 with
TF32 off: the same layers as :mod:`portbench.reference.lm`, the mean
next-token cross-entropy, and AdamW as a training mix states it.

The trained leaves are each weight-shared matrix's dictionary (its indices
stay as drawn), the embedding, the norm weights.  AdamW: the gradient
scaled to a global norm of at most ``clip_norm``, bias-corrected moments,
a linear warm-up to ``lr`` over ``warmup_steps`` and a cosine decay to
``min_lr_frac · lr`` at ``total_steps``, and decoupled weight decay on the
leaves the mix lists under ``decay`` (the embedding and the dictionaries,
each a matrix in the program's layout).  Each layer is recomputed in the
backward (``torch.utils.checkpoint``), so its activations are not all held.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import draw
from portbench.reference.lm import _layer, _rms_norm, _tables

__all__ = ["leaves", "train_steps", "leaf_names"]


def leaf_names(cfg: dict) -> list:
    """Every trained leaf's name, in order."""
    names = ["embed"]
    for i in range(cfg["n_layers"]):
        names += [f"layer{i}.attn_norm", f"layer{i}.ffn_norm"]
        names += [f"layer{i}.{m}" for m in draw.LM_MATRICES]
    return names + ["final_norm", "lm_head"]


def leaves(cfg: dict, seed: int, device) -> tuple:
    """``(trained leaves {name: f32 tensor}, indices {name: uint8 (K, N)})``
    drawn from the seed; the embedding in f32, as a training mix holds it."""
    out, idx = {"embed": draw.lm_embed(seed, cfg, device, torch.float32)}, {}
    for i in range(cfg["n_layers"]):
        for k, v in draw.lm_layer(seed, i, cfg, device).items():
            if isinstance(v, tuple):
                idx[f"layer{i}.{k}"], out[f"layer{i}.{k}"] = v
            else:
                out[f"layer{i}.{k}"] = v
    out["final_norm"] = draw.lm_norm(seed, "final_norm", cfg["d_model"], device)
    idx["lm_head"], out["lm_head"] = draw.lm_head(seed, cfg, device)
    return out, idx


class _Lookup(torch.autograd.Function):
    """``codebook[idx]``, whose gradient is each bin's sum of the weights'
    gradients, taken row block by row block (a scatter into ``(rows, bins)``
    and a sum over the rows: 16 bins shared by a whole matrix would
    serialize the adds)."""

    ROWS = 1024

    @staticmethod
    def forward(ctx, cb, idx):
        ctx.save_for_backward(idx)
        ctx.bins = cb.shape[0]
        return draw.dense_matrix(idx, cb)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros(ctx.bins, dtype=g.dtype, device=g.device)
        for r in range(0, idx.shape[0], _Lookup.ROWS):
            i = idx[r:r + _Lookup.ROWS].long()
            part = torch.zeros(i.shape[0], ctx.bins, dtype=g.dtype, device=g.device)
            out += part.scatter_add_(1, i, g[r:r + _Lookup.ROWS]).sum(0)
        return out, None


class _Round(torch.autograd.Function):
    """A control's operand rounding, passed straight through in the backward."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _loss(p: dict, idx: dict, cfg: dict, tokens, labels, rnd) -> torch.Tensor:
    if rnd is None:
        mm = torch.matmul
    else:
        def mm(a, b):
            return torch.matmul(_Round.apply(a, rnd), _Round.apply(b, rnd))

    B, T = tokens.shape
    tables = _tables(T, cfg["head_dim"], cfg["rope_theta"], tokens.device)
    hs = [p["embed"][tokens[r].long()] for r in range(B)]
    for i in range(cfg["n_layers"]):
        W = {m: _Lookup.apply(p[f"layer{i}.{m}"], idx[f"layer{i}.{m}"])
             for m in draw.LM_MATRICES}
        W["attn_norm"], W["ffn_norm"] = p[f"layer{i}.attn_norm"], p[f"layer{i}.ffn_norm"]
        hs = [checkpoint(lambda h, W=W: _layer(h, W, cfg, mm, tables), h, use_reentrant=False)
              for h in hs]
    head = _Lookup.apply(p["lm_head"], idx["lm_head"])
    total = torch.zeros((), device=tokens.device)
    for h, lab in zip(hs, labels):
        z = mm(_rms_norm(h, p["final_norm"], cfg["norm_eps"]), head)
        total = total - torch.log_softmax(z, -1).gather(1, lab.long()[:, None]).sum()
    return total / (B * T)


def _lr(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    t = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1), 0.0),
            1.0)
    return o["lr"] * warm * (o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5
                             * (1 + math.cos(math.pi * t)))


def train_steps(cfg: dict, seed: int, batches: list, opt: dict, device,
                rnd: Optional[Callable] = None) -> dict:
    """AdamW steps from the drawn leaves, one a batch ``(tokens, labels)``.
    Returns each step's ``loss``, the first step's gradient as the optimizer
    takes it (after the clip) by leaf, ``grad1``, and each leaf's change
    over the steps, ``delta``."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        p, idx = leaves(cfg, seed, device)
        p0 = {k: v.clone() for k, v in p.items()}
        m = {k: torch.zeros_like(v) for k, v in p.items()}
        v2 = {k: torch.zeros_like(v) for k, v in p.items()}
        losses, grad1 = [], None
        for step, (tok, lab) in enumerate(batches, start=1):
            x = {k: t.detach().requires_grad_() for k, t in p.items()}
            loss = _loss(x, idx, cfg, tok.to(device), lab.to(device), rnd)
            g = dict(zip(x, torch.autograd.grad(loss, list(x.values()))))
            losses.append(float(loss.detach()))
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g.values()))
            scale = torch.clamp(opt["clip_norm"] / (norm + 1e-9), max=1.0)
            g = {k: t * scale for k, t in g.items()}
            if grad1 is None:
                grad1 = g
            lr = _lr(opt, step)
            b1c, b2c = 1 - opt["b1"] ** step, 1 - opt["b2"] ** step
            for k in p:
                m[k] = opt["b1"] * m[k] + (1 - opt["b1"]) * g[k]
                v2[k] = opt["b2"] * v2[k] + (1 - opt["b2"]) * g[k] * g[k]
                d = (m[k] / b1c) / (torch.sqrt(v2[k] / b2c) + opt["eps"])
                if k.split(".")[-1] in opt["decay"]:
                    d = d + opt["weight_decay"] * p[k]
                p[k] = p[k] - lr * d
        return {"loss": losses, "grad1": grad1, "delta": {k: p[k] - p0[k] for k in p}}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
