"""Device meshes on ``torch.distributed``: the port's ``repro.launch.mesh``.

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``: one
program sees global arrays, and each device runs the body on its block.
PyTorch has no such program, so the port runs SPMD: one process a rank,
each building the same :class:`Mesh` and running the same code on its own
block of every sharded tensor, with explicit collectives where the JAX body
has them (:func:`all_gather`).

A rank sits at the row-major coordinates of its rank in the mesh shape, as
``jax.make_mesh`` lays devices out, and holds one process group per axis
of size > 1: the ranks that share every coordinate but that axis.  The
caller starts the processes and ``torch.distributed.init_process_group``
(its address, world size and rank); without a process group the world is
this one process, which builds any mesh of one rank.

Nothing here runs at import: building a mesh creates process groups.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve_device

__all__ = [
    "Mesh",
    "make_production_mesh",
    "make_conv_mesh",
    "axis_sizes",
    "data_model_sizes",
    "n_shard_axis",
    "all_gather",
    "all_reduce",
    "enter_split",
    "sum_over",
    "max_over",
    "barrier",
    "collective_bytes",
    "collective_ops",
    "reset_collective_bytes",
    "SINGLE_POD",
    "MULTI_POD",
]

SINGLE_POD = (16, 16)  # 256 chips
MULTI_POD = (2, 16, 16)  # 2 pods × 256 chips


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of a device mesh.

    ``shape`` gives each axis's size and ``axis_names`` its name; this rank
    sits at ``coords``; ``groups[i]`` is the process group along axis ``i``
    (``None`` when that axis has size 1: nothing to exchange); ``device`` is
    where this rank's blocks live and its kernels run.
    """

    shape: tuple
    axis_names: tuple
    coords: tuple
    groups: tuple
    device: torch.device

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r} (axes {self.axis_names})")
        return self.axis_names.index(axis)

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh lacks)."""
        return self.shape[self._axis(axis)] if axis in self.axis_names else 1

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 for an axis the mesh lacks)."""
        return self.coords[self._axis(axis)] if axis in self.axis_names else 0


def _world() -> tuple:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make_mesh(shape, axis_names: tuple, device) -> Mesh:
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or min(shape, default=0) < 1:
        raise ValueError(f"mesh shape {shape} does not fit axes {axis_names}")
    world, rank = _world()
    n = math.prod(shape)
    if n != world:
        raise ValueError(
            f"mesh shape {shape} needs {n} ranks but the process group has "
            f"{world}: start one process a rank (torch.distributed."
            "init_process_group with that world size)"
        )
    coords, r = [], rank
    for s in reversed(shape):
        r, c = divmod(r, s)
        coords.append(c)
    coords = tuple(reversed(coords))

    def ravel(c) -> int:
        out = 0
        for ci, s in zip(c, shape):
            out = out * s + ci
        return out

    groups = []
    for a, size in enumerate(shape):
        mine = None
        if size > 1:
            # new_group is collective over the world: every rank creates
            # every group of the axis, in the same order
            others = [range(s) for i, s in enumerate(shape) if i != a]
            for rest in itertools.product(*others):
                ranks = [ravel(rest[:a] + (j,) + rest[a:]) for j in range(size)]
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine = g
        groups.append(mine)
    return Mesh(shape, tuple(axis_names), coords, tuple(groups),
                resolve_device(device))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The production ``("data", "model")`` mesh (``("pod", "data",
    "model")`` across pods): :data:`SINGLE_POD` / :data:`MULTI_POD` ranks."""
    shape = MULTI_POD if multi_pod else SINGLE_POD
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_conv_mesh(shape=None, *, device=None) -> Mesh:
    """The ``("data", "model")`` mesh the sharded conv stack and the LM's
    tensor and expert parallelism (an active ``ShardCtx``) run on.

    ``shape=(n_data, n_model)`` must hold every rank of the process group;
    ``None`` puts every rank on ``data`` (pure batch sharding).  ``device``
    is this rank's device (default the card; pass ``"cpu"`` for the plain
    path).  The full AlexNet config records :data:`SINGLE_POD` in
    ``CNNConfig.mesh_shape``.
    """
    if shape is None:
        shape = (_world()[0], 1)
    return _make_mesh(shape, ("data", "model"), device)


def axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def data_model_sizes(mesh: Mesh) -> tuple:
    """``(n_data, n_model)`` of a conv/GEMM mesh; an absent ``model`` counts 1.

    The one definition every sharded layer derives its axis sizes from
    (``kernels/ops.py``, ``core/conv.py``, ``models/cnn.py``)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            f"mesh= takes a repro_torch.launch.mesh.Mesh, got {type(mesh).__name__}; "
            "build one with make_conv_mesh")
    if "data" not in mesh.axis_names:
        raise ValueError(
            f"mesh needs a 'data' axis (got axes {mesh.axis_names}); build "
            "one with repro_torch.launch.mesh.make_conv_mesh"
        )
    return mesh.size("data"), mesh.size("model")


def n_shard_axis(mesh: Mesh, n: int) -> Optional[str]:
    """The GEMM N dimension's mesh axis: ``"model"`` when it divides, else
    ``None`` (replicate).

    The one divisibility rule of the sharded dispatch:
    ``models/sharding.py::conv_param_pspecs`` applies the same test, so
    weight placement and compute never disagree."""
    _, nm = data_model_sizes(mesh)
    return "model" if nm > 1 and n % nm == 0 else None


# bytes of every collective's result on this rank, by collective: a plain
# counter a caller resets and reads around a step.  The forward's
# collectives count under their names (a remat's recompute in the backward
# counts there too); ``all_reduce_bwd`` is :func:`enter_split`'s backward
# and ``grad_reduce`` the train step's gradient reduction, its global norm
# and its non-finite probe (``models/sharding.py::reduce_grads``,
# ``train/optimizer.py``).  Three gathers of activations have keys of their
# own: ``relayout`` where a fused leaf's block does not line up with what a
# rank's state or the next leaf needs (mamba2's ``in_proj`` across ``z |
# xBC | dt``, a conv's channel block, heads cut by a column block),
# ``softmax_combine`` the sequence-sharded attention's partials, and
# ``cache_rows`` a recurrent state that ``cache_pspecs`` keeps whole on
# the batch, gathered over ``data`` after a rank updated its rows.  Two
# are the optimizer's: ``grad_max`` the MAX all-reduce of a split leaf's
# ``max |g|`` (``compress_grads(mesh=)``), ``zero_gather`` the updated
# params gathered over ``data`` from their ZeRO-1 blocks.  ``lm_loss`` is
# the train step's loss on a rank's logits block
# (``models/api.py::sharded_lm_loss``): its row max, exp sums and label
# logits over ``model``, and its sum and count over ``data``.
collective_bytes = {"all_gather": 0, "all_reduce": 0, "all_reduce_bwd": 0,
                    "grad_reduce": 0, "relayout": 0, "softmax_combine": 0,
                    "cache_rows": 0, "grad_max": 0, "zero_gather": 0, "lm_loss": 0}


# the same results by collective kind ("all-gather" / "all-reduce") and
# group size: ``[bytes, calls]``, what the roofline's ring weights read
# (``repro_torch.roofline.collective_stats``)
collective_ops: dict = {}


def reset_collective_bytes() -> None:
    for k in collective_bytes:
        collective_bytes[k] = 0
    collective_ops.clear()


def _count(key: str, kind: str, g, out: torch.Tensor) -> None:
    n = out.numel() * out.element_size()
    collective_bytes[key] += n
    rec = collective_ops.setdefault((kind, dist.get_world_size(g)), [0, 0])
    rec[0] += n
    rec[1] += 1


def _group(mesh: Mesh, axis: str):
    return mesh.groups[mesh._axis(axis)] if axis in mesh.axis_names else None


def _gather(t: torch.Tensor, g, dim: int, key: str = "all_gather") -> torch.Tensor:
    """Every rank's ``t`` in rank order on ``dim``, received into one
    tensor: on dim 0 it is the result (no copy); on another dim the rank
    axis moves beside it and one copy lays it out."""
    t = t.contiguous()  # a strided view (a slice of the last dim) is sent packed
    n = dist.get_world_size(g)
    buf = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(buf, t, group=g)
    dim %= t.ndim
    shape = t.shape[:dim] + (n * t.shape[dim],) + t.shape[dim + 1:]
    out = buf.view((n,) + tuple(t.shape)).movedim(0, dim).reshape(shape)
    _count(key, "all-gather", g, out)
    return out


def _sum(t: torch.Tensor, g, key: str, op=None) -> torch.Tensor:
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op is None else op, group=g)
    _count(key, "all-reduce", g, out)
    return out


def _check_grad(g: torch.Tensor, shape, what: str) -> None:
    """A backward collective's operand must have the forward's shape: a
    mismatch would reach the other ranks as a collective of another size."""
    if tuple(g.shape) != tuple(shape):
        raise ValueError(f"{what}'s backward got a gradient of shape "
                         f"{tuple(g.shape)} for its output of shape {tuple(shape)}")


def _differentiable(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllGather(torch.autograd.Function):
    """The tiled gather; its backward is this rank's block of the incoming
    gradient.  The gathered tensor's consumer is replicated over the axis,
    so the gradient that arrives is the same on every rank of it."""

    @staticmethod
    def forward(ctx, t, g, dim, index, key):
        out = _gather(t, g, dim, key)
        ctx.g_dim, ctx.index, ctx.n, ctx.shape = dim, index, t.shape[dim], out.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        _check_grad(grad, ctx.shape, "all_gather")
        return grad.narrow(ctx.g_dim, ctx.index * ctx.n, ctx.n), None, None, None, None


class _AllReduce(torch.autograd.Function):
    """The sum of partials; its backward is the identity (the sum's
    consumer is replicated, so each partial's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, t, g, key):
        ctx.shape = t.shape
        return _sum(t, g, key)

    @staticmethod
    def backward(ctx, grad):
        _check_grad(grad, ctx.shape, "all_reduce")
        return grad, None, None


class _EnterSplit(torch.autograd.Function):
    """The identity; its backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, t, g):
        ctx.g, ctx.shape = g, t.shape
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        _check_grad(grad, ctx.shape, "enter_split")
        return _sum(grad, ctx.g, "all_reduce_bwd"), None


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0,
               key: str = "all_gather") -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated on ``dim`` in
    coordinate order: JAX's tiled ``all_gather``, so the N blocks of a
    ``model``-sharded output gather to the full-N output bitwise.  Every
    rank's block has ``t``'s shape (any view: a slice of the last dim is
    sent packed).  Its bytes count under ``key`` of
    :data:`collective_bytes`.  An axis of size 1 returns ``t``.

    Differentiable: the backward is this rank's block of the gradient,
    which every rank of the axis receives whole and equal (the result's
    consumer runs replicated; :func:`enter_split` makes it so)."""
    g = _group(mesh, axis)
    if g is None:
        return t
    if _differentiable(t):
        return _AllGather.apply(t, g, dim % t.ndim, mesh.index(axis), key)
    return _gather(t, g, dim, key)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str,
               key: str = "all_reduce") -> torch.Tensor:
    """The sum over ``axis`` of every rank's ``t`` (a new tensor; ``t`` is
    not changed), the same on every rank of the group, counted under
    ``key``.  The row-parallel linears' partials and the expert combine
    take it in f32.  An axis of size 1 returns ``t``.  Differentiable: the
    backward is the identity."""
    g = _group(mesh, axis)
    if g is None:
        return t
    if _differentiable(t):
        return _AllReduce.apply(t, g, key)
    return _sum(t, g, key)


def enter_split(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` itself, for a tensor replicated over ``axis`` that enters
    rank-distinct work (an N block of a linear, a K block's ``narrow``, a
    rank's rows or experts): the backward all-reduces the gradient over
    ``axis``, so the replicated tensor gets the whole gradient on every
    rank (Megatron's pairing with :func:`all_gather` / :func:`all_reduce`).
    An axis of size 1, or a tensor that needs no gradient, returns ``t``."""
    g = _group(mesh, axis)
    if g is None or not _differentiable(t):
        return t
    return _EnterSplit.apply(t, g)


def sum_over(t: torch.Tensor, mesh: Mesh, axes, key: str = "grad_reduce") -> torch.Tensor:
    """``t`` summed over each of ``axes`` in turn (not differentiable; the
    train step's reductions), counted under ``key``.  Axes of size 1 and
    absent axes are skipped; with none left ``t`` itself comes back."""
    for axis in axes:
        g = _group(mesh, axis)
        if g is not None:
            t = _sum(t, g, key)
    return t


def max_over(t: torch.Tensor, mesh: Mesh, axes, key: str = "grad_max") -> torch.Tensor:
    """The elementwise max of ``t`` over each of ``axes`` in turn (not
    differentiable; exact in any order), counted under ``key``.  Axes of
    size 1 and absent axes are skipped; with none left ``t`` itself comes
    back."""
    for axis in axes:
        g = _group(mesh, axis)
        if g is not None:
            t = _sum(t, g, key, dist.ReduceOp.MAX)
    return t


def barrier(mesh: Optional[Mesh] = None, flag: bool = False) -> bool:
    """Wait for every rank of the process group, and return whether any
    rank passed ``flag`` (a world all-reduce of it on ``mesh``'s device):
    a failure one rank saw reaches all of them.  Without a process group
    it returns ``flag``."""
    world, _ = _world()
    if world == 1:
        return flag
    dev = mesh.device if mesh is not None else torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=dev)
    dist.all_reduce(t)
    return bool(int(t.item()))
