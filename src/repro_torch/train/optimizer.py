"""AdamW with cosine schedule, gradient clipping and a PASM compression hook.

Port of ``repro.train.optimizer``.  The update is functional: it returns
new tensors and never writes into the old ones, so :func:`tree_select` can
hand the old leaves back with their bits intact (the non-finite guard's
skip path).  Every scalar (step, learning rate, clip scale, the guard's
probe) stays a device tensor, so a step needs no host synchronisation.

Trees are those of :mod:`repro_torch.tree`: integer leaves (PASM indices)
are frozen, their moments 0-d placeholders; decoupled weight decay applies
to leaves with ``ndim >= 2``.  Under a mesh the trees hold a rank's blocks:
:func:`global_norm` and :func:`nonfinite_probe` take the mesh, so the clip
scale is the one-device one and every rank takes the same skip.  The
moments follow the params' layout, or with ``init_opt_state(mesh=)`` JAX's
ZeRO-1 layout (:class:`ZeroOptState`, ``models/sharding.py::zero_specs``):
a rank holds a ``1/data`` block of each moment, updates that block of its
params and gathers them over ``data``; the update is elementwise, so the
step is bitwise the one with whole moments.  The port's per-layer leaves
are unstacked, so a layer's norm scale ``(D,)`` is not decayed where the
JAX package's stacked ``(L, D)`` one is (a deliberate difference);
:func:`compress_grads` does read the lists as JAX's stacked leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.tree import STACKED, flatten_with_path, tree_leaves, tree_map, tree_unflatten

__all__ = ["AdamWConfig", "OptState", "ZeroOptState", "init_opt_state", "adamw_update", "cosine_lr",
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


class ZeroOptState(OptState):
    """An :class:`OptState` whose moments are JAX's ZeRO-1 blocks of a
    placed params tree (:func:`init_opt_state` with ``mesh=``): the type
    marks the layout for ``models/sharding.py::placed_specs``."""

    __slots__ = ()


def _f32_like(params: Any, dims: dict, n: int) -> Any:
    """f32 zeros shaped as ``params``' leaves, the leaf at each path of
    ``dims`` cut to ``1/n`` along its dim; integer leaves (PASM idx) get
    placeholder scalars — never updated."""
    out = []
    for path, x in flatten_with_path(params):
        shape = list(x.shape) if x.is_floating_point() else []
        if path in dims:
            shape[dims[path]] //= n
        out.append(torch.zeros(shape, dtype=torch.float32, device=x.device))
    return tree_unflatten(params, out)


def init_opt_state(params: Any, *, mesh=None) -> OptState:
    """Zero moments with the params' layout; with ``mesh`` (``params``
    placed by ``models/sharding.py::place_params``) JAX's ZeRO-1 layout
    instead: a :class:`ZeroOptState` holding this rank's ``1/data`` block
    of every moment ``zero_specs`` cuts over ``data``."""
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    if mesh is None:
        return OptState(step, _f32_like(params, {}, 1), _f32_like(params, {}, 1))
    from repro_torch.models.sharding import zero_dims

    dims, n = zero_dims(params, mesh), mesh.size("data")
    return ZeroOptState(step, _f32_like(params, dims, n), _f32_like(params, dims, n))


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


def _aligned(params: Any, tree: Any) -> list:
    """``tree``'s leaves in ``params``' leaf order, ``None`` where ``tree``
    holds none (a gradient tree's integer leaves)."""
    out: list = []
    tree_map(lambda _, t: out.append(t), params, tree)
    return out


def adamw_update(params: Any, grads: Any, state: OptState,
                 cfg: AdamWConfig, *, mesh=None, block_axes: Optional[dict] = None,
                 zero_dims: Optional[dict] = None) -> tuple:
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``.
    ``mesh``/``block_axes``: the placement :func:`global_norm` reads.
    ``zero_dims`` (``models/sharding.py::zero_dims``, for a
    :class:`ZeroOptState` under ``mesh``): the leaf at each path updates
    this rank's ``1/data`` block along its dim, from the same block of its
    gradient, and is gathered over ``data`` (``zero_gather``)."""
    from repro_torch.launch.mesh import all_gather

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

    dims = zero_dims or {}
    i = mesh.index("data") if dims else 0
    out = []
    for (path, p), g, m, v in zip(flatten_with_path(params), _aligned(params, grads),
                                  _aligned(params, state.mu), _aligned(params, state.nu)):
        d = dims.get(path) if g is not None else None
        if d is None:
            out.append(upd(p, g, m, v))
            continue
        n = m.shape[d]
        p2, m, v = upd(p.narrow(d, i * n, n), g.narrow(d, i * n, n), m, v)
        with torch.no_grad():
            out.append((all_gather(p2, mesh, "data", dim=d, key="zero_gather"), m, v))
    pick = lambda j: tree_unflatten(params, [o[j] for o in out])  # noqa: E731
    return pick(0), type(state)(step, pick(1), pick(2)), {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# gradient compression (beyond paper): weight-share the all-reduce payload
# ---------------------------------------------------------------------------


def _stacked_path(path: tuple) -> tuple:
    """``(JAX leaf path, stacked)``: the path with a per-layer list's index
    dropped, and whether it had one."""
    for i, k in enumerate(path[:-1]):
        if k in STACKED and path[i + 1].isdigit():
            return path[:i + 1] + path[i + 2:], True
    return path, False


def compress_grads(grads: Any, bins: int = 256, *, mesh=None,
                   block_axes: Optional[dict] = None) -> Any:
    """Quantize each gradient matrix to a symmetric uniform ``bins``-entry
    dictionary of ``max |g|`` before the data-parallel all-reduce — the
    PASM storage trick on the collective payload.  The error is bounded by
    half a bin width.

    The dictionary is JAX's, leaf for leaf: JAX stacks a per-layer list's
    leaves (``layers``, ``groups``, ``enc_layers``, ``dec_layers``) on a
    leading axis, so one ``max |g|`` covers a path over every layer of the
    list, and a per-layer leaf is compressed whenever its stacked form has
    ``ndim >= 2`` (a layer's ``(D,)`` norm scale too).  Other leaves
    (``dense_layers``, the hybrid's ``tail``, the embeddings) are
    compressed alone when ``ndim >= 2``.

    ``mesh=``: ``grads`` hold a rank's blocks (of a placed tree's
    gradient, reduced).  As the JAX package compresses the global
    gradient, each dictionary's ``max |g|`` is the whole leaf's, a MAX
    all-reduce over the axes its blocks split on (``block_axes``, default
    ``models/sharding.py::block_axes`` of ``grads``; counted under
    ``grad_max``), so a rank's result is bitwise its block of
    ``compress_grads(gather_params(grads))``."""
    from repro_torch.launch.mesh import max_over

    flat = flatten_with_path(grads)
    key_of, local = {}, {}
    for path, g in flat:
        if not g.is_floating_point():
            continue
        key, stacked = _stacked_path(path)
        if g.ndim + stacked >= 2:
            key_of[path] = key
            m = torch.max(torch.abs(g.to(torch.float32)))
            local[key] = m if key not in local else torch.maximum(local[key], m)
    if mesh is not None:
        if block_axes is None:
            from repro_torch.models.sharding import block_axes as _block_axes

            block_axes = _block_axes(grads, mesh)
        axes: dict = {}
        for path, key in key_of.items():
            axes[key] = tuple(sorted(set(axes.get(key, ())) | set(block_axes.get(path, ()))))
        groups: dict = {}
        for key, ax in axes.items():
            if ax:
                groups.setdefault(ax, []).append(key)
        for ax, keys in groups.items():  # one all-reduce a group of axes
            tot = max_over(torch.stack([local[k] for k in keys]), mesh, ax)
            for j, k in enumerate(keys):
                local[k] = tot[j]

    def one(path, g):
        if path not in key_of:
            return g
        scale = (bins / 2 - 1) / (local[key_of[path]] + 1e-12)
        q = torch.clamp(torch.round(g.to(torch.float32) * scale), -(bins / 2 - 1),
                        bins / 2 - 1)
        return (q / scale).to(g.dtype)

    return tree_unflatten(grads, [one(p, g) for p, g in flat])
