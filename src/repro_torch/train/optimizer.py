"""AdamW with cosine schedule, gradient clipping and a PASM compression hook.

Port of ``repro.train.optimizer``.  The update is functional: it returns
new tensors and never writes into the old ones, so :func:`tree_select` can
hand the old leaves back with their bits intact (the non-finite guard's
skip path).  Every scalar (step, learning rate, clip scale, the guard's
probe) stays a device tensor, so a step needs no host synchronisation.

Trees are those of :mod:`repro_torch.tree`: integer leaves (PASM indices)
are frozen, their moments 0-d placeholders; decoupled weight decay applies
to leaves with ``ndim >= 2``.  Under a mesh the trees hold a rank's blocks
and the moments follow the params' layout: :func:`global_norm` and
:func:`nonfinite_probe` take the mesh, so the clip scale is the one-device
one and every rank takes the same skip.  The port's per-layer leaves are unstacked
(ROADMAP Queue 3), so a layer's norm scale ``(D,)`` is not decayed where
the JAX package's stacked ``(L, D)`` one is.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import flatten_with_path, tree_leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "init_opt_state", "adamw_update", "cosine_lr",
           "global_norm", "compress_grads", "nonfinite_probe", "tree_select"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: Any
    nu: Any


def _f32_like(tree: Any) -> Any:
    # integer leaves (PASM idx) get placeholder scalars — never updated
    return tree_map(lambda x: torch.zeros(x.shape if x.is_floating_point() else (),
                                          dtype=torch.float32, device=x.device), tree)


def init_opt_state(params: Any) -> OptState:
    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=_f32_like(params), nu=_f32_like(params))


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; f32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any, *, mesh=None, block_axes: Optional[dict] = None) -> torch.Tensor:
    """The L2 norm over every floating leaf.  Under ``mesh`` a leaf held as
    a block over axes (``block_axes[path]``,
    ``models/sharding.py::block_axes``) adds its squared sum all-reduced
    over them, and a whole leaf counts once: the one-device norm on every
    rank.  The squared sums are added in leaf order, so a mesh of one rank
    gives the unsharded norm bitwise."""
    from repro_torch.launch.mesh import sum_over

    flat = [(p, x) for p, x in flatten_with_path(tree) if x.is_floating_point()]
    sq = [torch.sum(torch.square(x.to(torch.float32))) for _, x in flat]
    groups: dict = {}
    for i, (p, _) in enumerate(flat):
        ax = (block_axes or {}).get(p, ()) if mesh is not None else ()
        if ax:
            groups.setdefault(ax, []).append(i)
    for ax, idx in groups.items():  # one all-reduce a group of axes
        tot = sum_over(torch.stack([sq[i] for i in idx]), mesh, ax)
        for j, i in enumerate(idx):
            sq[i] = tot[j]
    return torch.sqrt(sum(sq))


def nonfinite_probe(loss: torch.Tensor, grads: Any, *, mesh=None) -> torch.Tensor:
    """ONE finiteness check over loss + every floating grad leaf.

    Returns a bool scalar tensor: True iff the loss and all gradient
    elements are finite.  Each leaf contributes ``sum(g * 0)``, exactly 0
    when the leaf is all-finite and NaN otherwise (``inf * 0`` and
    ``nan * 0`` are NaN in IEEE-754), so the tree folds into one scalar on
    the device: no per-leaf host sync.  Under ``mesh`` the scalar is summed
    over every axis, so a non-finite block on one rank skips the step on
    all of them and the ranks' trees stay one state.
    """
    from repro_torch.launch.mesh import sum_over

    z = loss.to(torch.float32)
    for g in tree_leaves(grads):
        if g.is_floating_point():
            z = z + torch.sum(g.to(torch.float32) * 0.0)
    if mesh is not None:
        z = sum_over(z.reshape(1), mesh, mesh.axis_names)[0]
    return torch.isfinite(z)


def tree_select(pred: torch.Tensor, on_true: Any, on_false: Any) -> Any:
    """Per-leaf ``where(pred, a, b)`` — the skip path of the non-finite
    guard: selecting the OLD leaves keeps params/opt_state bit-identical
    (``where`` copies the operand's bits)."""
    return tree_map(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: AdamWConfig, *, mesh=None, block_axes: Optional[dict] = None) -> tuple:
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``.
    ``mesh``/``block_axes``: the placement :func:`global_norm` reads."""
    gnorm = global_norm(grads, mesh=mesh, block_axes=block_axes)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=step.device), step.to(torch.float32))
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=step.device), step.to(torch.float32))

    def upd(p, g, m, v):
        if not p.is_floating_point():
            return p, m, v  # integer leaves (PASM indices) are frozen
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    pick = lambda i: tree_map(lambda _, o: o[i], params, out)  # noqa: E731
    return pick(0), OptState(step, pick(1), pick(2)), {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (beyond paper): weight-share the all-reduce payload
# ---------------------------------------------------------------------------


def compress_grads(grads: Any, bins: int = 256, *, mesh=None) -> Any:
    """Quantize each gradient matrix to a symmetric uniform ``bins``-entry
    dictionary of ``max |g|`` before the data-parallel all-reduce — the
    PASM storage trick on the collective payload.  The error is bounded by
    half a bin width.  ``mesh=`` raises: the JAX package compresses the
    global gradient, and a block's ``max |g|`` is another dictionary
    (ROADMAP Queue 1 item 13b)."""
    if mesh is not None:
        from repro_torch.core.params import NOT_PORTED_MESH_TRAIN

        raise NotImplementedError(NOT_PORTED_MESH_TRAIN)

    def one(g):
        if g.ndim < 2 or not g.is_floating_point():
            return g
        gf = g.to(torch.float32)
        amax = torch.max(torch.abs(gf)) + 1e-12
        scale = (bins / 2 - 1) / amax
        q = torch.clamp(torch.round(gf * scale), -(bins / 2 - 1), bins / 2 - 1)
        return (q / scale).to(g.dtype)

    return tree_map(one, grads)
