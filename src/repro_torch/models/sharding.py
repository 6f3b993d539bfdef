"""Sharding rules: partition specs by path, and a rank's block of a tensor.

Port of ``repro.models.sharding``, every function pure.  Megatron-style TP
on the ``model`` axis (column→row pairs per block), EP for MoE experts, DP
over ``data`` (and ``pod``), ZeRO-1 for optimizer states.  The rules match
paths, so one table covers dense leaves and the ``idx``/``codebook`` leaves
PASM quantization swaps in.  A tree's path is
:func:`repro_torch.tree.flatten_with_path`'s: dict keys, list indices and
dataclass field names joined by ``/`` (per-layer lists put an index where
the JAX package stacks a leading dim; leading dims take ``None`` either
way).

The CNN conv stack has its own rules (:func:`conv_param_pspecs`,
:func:`conv_input_pspecs`, :func:`conv_batch_pad`): output channels over
``model``, image batches over ``data``, codebooks replicated — the axis
mapping of ``conv2d(mesh=)``.  The LM tables (:func:`param_pspecs`,
:func:`opt_state_pspecs`, :func:`cache_pspecs`, :func:`batch_axes`,
:func:`input_pspecs`) are ported with their rules; every LM family's
tensor parallelism (an active ``ShardCtx``) runs on params placed by
:func:`param_pspecs` (:func:`place_params`) and caches placed by
:func:`cache_pspecs` (:func:`place_caches`; :func:`gather_caches` is the
inverse).

:func:`local_shard` is the port's own: ``jax.device_put`` onto a
``NamedSharding`` keeps a global array whose blocks live on the devices;
under SPMD a rank holds its block, and this slices it out.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core.params import PasmParams
from repro_torch.tree import flatten_with_path, tree_map, tree_unflatten

__all__ = [
    "P",
    "param_pspecs",
    "cache_pspecs",
    "batch_axes",
    "input_pspecs",
    "opt_state_pspecs",
    "conv_param_pspecs",
    "conv_input_pspecs",
    "conv_batch_pad",
    "local_shard",
    "place_params",
    "place_tree",
    "placed_specs",
    "zero_specs",
    "zero_dims",
    "gather_params",
    "global_like",
    "block_axes",
    "grad_reduce_axes",
    "reduce_grads",
    "place_caches",
    "gather_caches",
]

MODEL = "model"
DATA = "data"


class P(tuple):
    """A partition spec, the port's ``jax.sharding.PartitionSpec``: per
    dimension a mesh axis name, a tuple of names (the dimension splits over
    their product, the first outermost) or ``None`` (replicated).  Dimensions
    past its length are replicated.  As in JAX, a tuple of one name is that
    name and an empty tuple is ``None``."""

    def __new__(cls, *dims):
        def norm(d):
            if isinstance(d, (tuple, list)):
                d = tuple(d)
                return d[0] if len(d) == 1 else (d or None)
            return d
        return super().__new__(cls, tuple(norm(d) for d in dims))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def batch_axes(multi_pod: bool, global_batch: int, n_data: int = 16, n_pod: int = 2):
    """Axes the batch dim shards over; () when the batch is too small (long_500k)."""
    total = n_data * (n_pod if multi_pod else 1)
    if global_batch % total == 0:
        return ("pod", "data") if multi_pod else ("data",)
    if global_batch % n_data == 0:
        return ("data",)
    return ()


# rules: regex over the flattened path → spec for the TRAILING dims.
# Earlier rules win.  Leading (per-layer / expert-stack) dims take None.
_RULES: list = [
    # PASM leaves inherit their parent weight's layout (idx) / replicate (codebook)
    (r"codebook$", ("__REPL__",)),
    # MoE experts: 2-D sharding — E over model (EP), FFN hidden over data
    (r"moe/w[13](/idx)?$", (MODEL, None, "data")),
    (r"moe/w2(/idx)?$", (MODEL, "data", None)),
    # column-parallel (output dim sharded)
    (r"(wq|wk|wv|w1|w3|shared_w1|shared_w3|rec_in|in_proj|w_a|w_x)(/idx)?$", (None, MODEL)),
    # row-parallel (input dim sharded)
    (r"(wo|w2|shared_w2|rec_out|out_proj)(/idx)?$", (MODEL, None)),
    # embeddings: vocab-sharded; lm_head column-parallel
    (r"embed(/idx)?$", (MODEL, None)),
    (r"lm_head(/idx)?$", (None, MODEL)),
    (r"vproj(/idx)?$", (None, None)),
    (r"pos_embed$", (None, None)),
    # depthwise conv / gates / per-channel vectors: channel dim sharded
    (r"conv_w$", (None, MODEL)),
    (r"(conv_b|lam|b_a|b_x|ssm_norm)$", (MODEL,)),
    (r"router$", (None, None)),
]


def _path_str(path: tuple) -> str:
    return "/".join(path)


def _map_with_path(fn, tree: Any) -> Any:
    """``fn(path string, leaf)`` over ``tree``'s leaves, same structure."""
    return tree_unflatten(tree, [fn(_path_str(p), leaf)
                                 for p, leaf in flatten_with_path(tree)])


def _spec_for(path_s: str, ndim: int) -> P:
    for pat, tail in _RULES:
        if re.search(pat, path_s):
            if tail == ("__REPL__",):
                return P(*([None] * ndim))
            pad = ndim - len(tail)
            if pad < 0:  # leaf smaller than the rule (smoke dims): replicate
                return P(*([None] * ndim))
            return P(*([None] * pad + list(tail)))
    return P(*([None] * ndim))  # norms, biases, scalars → replicated


def _axes(ax) -> tuple:
    return ax if isinstance(ax, tuple) else (ax,)


def _divisible(shape, spec: P, axis_sizes: dict) -> bool:
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        size = 1
        for a in _axes(ax):
            size *= axis_sizes[a]
        if dim % size:
            return False
    return True


def param_pspecs(params: Any, axis_sizes: dict) -> Any:
    """The spec tree matching ``params`` (a container contributes its
    ``idx``/``codebook`` leaves).  A dim that does not divide its mesh axis
    replicates the leaf (small smoke shapes); full configs shard cleanly."""

    def one(path, leaf):
        s = _spec_for(path, leaf.ndim)
        if not _divisible(leaf.shape, s, axis_sizes):
            return P(*([None] * leaf.ndim))
        return s

    return _map_with_path(one, params)


def opt_state_pspecs(params: Any, pspecs: Any, axis_sizes: dict) -> Any:
    """ZeRO-1: Adam moments additionally shard their largest replicated dim
    over ``data``.  Falls back to the param spec when nothing divides."""
    n_data = axis_sizes.get("data", 1)

    def used_axes(spec):
        out = set()
        for d in spec:
            if d is not None:
                out.update(_axes(d))
        return out

    def one(leaf, spec):
        if leaf.ndim == 0:
            return P()
        if "data" in used_axes(spec):
            return spec  # already data-sharded (2-D expert sharding / FSDP)
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        # the largest dim not already sharded that divides n_data
        cands = [(leaf.shape[i], i) for i in range(leaf.ndim)
                 if dims[i] is None and leaf.shape[i] % n_data == 0
                 and leaf.shape[i] >= n_data]
        if not cands:
            return P(*dims)
        _, i = max(cands)
        dims[i] = "data"
        return P(*dims)

    return tree_map(one, params, pspecs)


def cache_pspecs(cfg, caches: Any, axis_sizes: dict, batch: tuple) -> Any:
    """KV/state cache specs.  KV heads shard over ``model`` when divisible,
    else the sequence dim takes ``model``."""
    tp = axis_sizes.get(MODEL, 1)
    kv_on_model = cfg.n_kv_heads and cfg.n_kv_heads % tp == 0

    def one(name, leaf):
        nd = leaf.ndim
        dims = [None] * nd
        if nd >= 4 and re.search(r"(^|/)(k|v)(_q)?$", name):
            # (L?, B, S, KV, hd)
            dims[-4] = batch if batch else None
            if kv_on_model:
                dims[-2] = MODEL
            elif leaf.shape[-3] % tp == 0:
                dims[-3] = MODEL
        elif nd >= 3 and re.search(r"(^|/)(k|v)_scale$", name):
            # (L?, B, S, KV) — mirror the cache layout on S/KV
            dims[-3] = batch if batch else None
            if kv_on_model:
                dims[-1] = MODEL
            elif leaf.shape[-2] % tp == 0:
                dims[-2] = MODEL
        elif re.search(r"ssm$", name) and nd >= 4:
            # (L, B, H, P, N): shard P (head_dim) when divisible
            dims[-4] = batch if batch else None
            if leaf.shape[-2] % tp == 0:
                dims[-2] = MODEL
        elif re.search(r"(conv$|^h$|/h$)", name) and nd >= 2:
            # recurrent states: (.., B, .., channels) — channels on model
            if leaf.shape[-1] % tp == 0 and leaf.shape[-1] >= tp:
                dims[-1] = MODEL
        return P(*dims)

    return _map_with_path(one, caches)


def input_pspecs(specs: dict, batch: tuple) -> dict:
    """Token/label/frontend inputs: batch-sharded on dim 0, replicated elsewhere."""
    return {k: P(*([batch if batch else None] + [None] * (len(v.shape) - 1)))
            for k, v in specs.items()}


# ---------------------------------------------------------------------------
# CNN conv stack (models/cnn.py): ConvParams dictionaries + head
# ---------------------------------------------------------------------------


def conv_param_pspecs(params: Any, axis_sizes: dict) -> Any:
    """Specs for the CNN param dict (``{"conv": [ConvParams...], "head":
    {...}}``): the sharded conv dispatch's weight placement.

    The GEMM N dimension (``c_out``) shards over ``model``: dim 0 of a 4-D
    ``kernel``/``idx`` leaf ``(c_out, c_in, ky, kx)``, dim 1 of a packed
    2-D ``idx (Kp//2, c_out)`` (the K-major int4 pairing stays whole); bias
    and the head follow it, and codebooks replicate.  A ``c_out`` that does
    not divide ``model`` replicates that leaf, the dispatch's N-replicated
    rule, so placement never disagrees with compute.  Activations are not
    in this table: each sharded conv all-gathers its output channels, so
    they leave every layer ``model``-replicated and ``data``-sharded.
    """

    def one(name, leaf):
        nd = leaf.ndim
        dims = [None] * nd
        if re.search(r"codebook$", name):
            pass  # per-layer dictionary: replicated everywhere
        elif re.search(r"(kernel|idx)$", name) and nd == 4:
            dims[0] = MODEL  # (c_out, c_in, ky, kx): output channels
        elif re.search(r"idx$", name) and nd == 2:
            dims[1] = MODEL  # packed (Kp//2, c_out): output channels minor
        elif re.search(r"(bias|head/b)$", name) and nd == 1:
            dims[0] = MODEL  # per-output-channel vectors ride the N sharding
        elif re.search(r"head/w$", name) and nd == 2:
            dims[1] = MODEL  # classifier column-parallel
        s = P(*dims)
        if not _divisible(leaf.shape, s, axis_sizes):
            return P(*([None] * nd))
        return s

    return _map_with_path(one, params)


def conv_input_pspecs(ndim: int = 4) -> P:
    """Image batches shard over ``data`` on the leading batch dim (both
    NCHW and NHWC keep batch leading)."""
    return P(DATA, *([None] * (ndim - 1)))


def conv_batch_pad(batch: int, n_data: int) -> int:
    """Zero images to append so an uneven batch shards over ``data``
    (``conv2d(mesh=)`` pads and slices them off itself)."""
    return -batch % n_data


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of the global tensor ``t`` under ``spec`` on
    ``mesh``: each sharded dim narrowed to the rank's coordinate along its
    axes (a view; the caller copies what it keeps).  Raises when a sharded
    dim does not divide its axes."""
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        n, i = 1, 0
        for a in _axes(ax):
            n, i = n * mesh.size(a), i * mesh.size(a) + mesh.index(a)
        if t.shape[dim] % n:
            raise ValueError(
                f"dim {dim} of {tuple(t.shape)} does not divide over {ax} ({n} ranks)")
        step = t.shape[dim] // n
        t = t.narrow(dim, i * step, step)
    return t


# ---------------------------------------------------------------------------
# the LM: a rank's block of the params and caches (the SPMD placement)
# ---------------------------------------------------------------------------


def _size(ax, mesh) -> int:
    n = 1
    for a in _axes(ax):
        n *= mesh.size(a)
    return n


def _copy_block(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    return local_shard(t, spec, mesh).to(mesh.device).clone()


def _whole(t) -> P:
    return P(*([None] * t.ndim))


def _node_spec(node: Any, spec: Any, mesh) -> Any:
    """The spec a container is placed by: ``spec``, except that a K split
    of a ``PasmParams`` that would cut a dictionary group leaves the leaf
    whole (every field replicated).  ``node`` may be a gradient tree's
    container (``None`` at its integer indices)."""
    if not isinstance(node, PasmParams):
        return spec
    sa = spec.w if node.kind == "dense" else spec.idx
    k_ax = sa[-2] if sa is not None and len(sa) >= 2 else None
    if k_ax is not None and node.groups > 1 and node.groups % _size(k_ax, mesh):
        return tree_map(_whole, node)
    return spec


def _is_container(node: Any) -> bool:
    return dataclasses.is_dataclass(node) and not isinstance(node, type)


def _place_node(node: Any, spec: Any, mesh, wrap: bool, like: Any = None) -> Any:
    def kids(i):  # the like tree's child, when there is one
        return None if like is None else like[i]

    if isinstance(node, dict):
        return {k: _place_node(v, spec[k], mesh, wrap, kids(k)) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_place_node(v, s, mesh, wrap, kids(i))
                            for i, (v, s) in enumerate(zip(node, spec))))
    if isinstance(node, (list, tuple)):
        return type(node)(_place_node(v, s, mesh, wrap, kids(i))
                          for i, (v, s) in enumerate(zip(node, spec)))
    if _is_container(node):
        spec = _node_spec(node, spec, mesh)
        out = dataclasses.replace(node, **{
            f.name: _copy_block(getattr(node, f.name), getattr(spec, f.name), mesh)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
        if isinstance(node, PasmParams) and node.lead is None:
            name = _main_field(node)
            t = getattr(node, name)
            if t is not None and t.ndim >= 2:
                out = dataclasses.replace(out, lead=_lead_of(t, getattr(out, name)))
        return out
    if not isinstance(node, torch.Tensor):
        return node
    block = _copy_block(node, spec, mesh)
    if like is not None:
        wrap = isinstance(like, PasmParams)
    if wrap and node.ndim >= 2 and tuple(block.shape) != tuple(node.shape):
        # a dense matrix held as a block keeps its logical shape, as a
        # quantized leaf does (params.tp_linear reads the block off it)
        return PasmParams(w=block, kind="dense", shape=tuple(node.shape[-2:]),
                          lead=_lead_of(node, block))
    return block


def _lead_of(t: torch.Tensor, block: torch.Tensor):
    """The global leading dims of ``t`` where ``block`` holds a block of
    them (an expert stack's E over ``model``), else ``None``."""
    lead = tuple(t.shape[:-2])
    return lead if lead != tuple(block.shape[:-2]) else None


def place_tree(tree: Any, specs: Any, mesh, *, wrap: bool = True, like: Any = None) -> Any:
    """This rank's block of every leaf of ``tree`` by the spec tree
    ``specs``, copied out on ``mesh.device``.  ``wrap`` (the LM's
    :func:`place_params`) turns a dense matrix held as a block into a
    ``dense`` ``PasmParams`` of its logical shape; the CNN's placement
    (``cnn._place``) keeps a container's global ``kshape`` instead.  With
    ``like`` (a placed tree of the same structure: a restore's template)
    a block is wrapped exactly where ``like`` holds a ``PasmParams``."""
    return _place_node(tree, specs, mesh, wrap, like)


def place_params(params: Any, mesh) -> Any:
    """This rank's block of every leaf of an LM params tree by
    :func:`param_pspecs` (the LM counterpart of ``cnn._place``), copied out
    on ``mesh.device`` so a rank's weight memory shrinks with the mesh.

    A ``PasmParams`` keeps its global metadata (``shape``, ``bins``,
    ``pad_k``) over the held block, and its codebooks whole (replicated, as
    the spec says); a dense matrix held as a block becomes a ``dense``
    ``PasmParams`` that keeps its logical shape the same way.  A dim that
    does not divide its axis leaves the leaf whole (``_divisible``: e.g. a
    vocab of 92553), as does a K split that would cut a dictionary group
    (``groups`` not a multiple of the axis); such a leaf is computed whole
    on every rank.  Packed int4 bytes hold two K rows, so a K block of
    them starts on an even row and holds the §3 pad row whole."""
    from repro_torch.launch.mesh import axis_sizes

    return _place_node(params, param_pspecs(params, axis_sizes(mesh)), mesh, True)


# ---------------------------------------------------------------------------
# training on placed trees: the global view, gathering, gradient reduction
# ---------------------------------------------------------------------------


def _walk(node: Any, spec: Any, mesh, path: tuple, out: list) -> None:
    """``(path, leaf, spec, owner)`` for every leaf of a placed tree in
    :func:`repro_torch.tree.flatten_with_path`'s order, ``spec`` the one it
    was placed by and ``owner`` ``(container, its placed spec)`` for a field
    of a container."""
    if node is None:
        return
    if isinstance(node, torch.Tensor):
        out.append((path, node, spec, None))
    elif isinstance(node, dict):
        for k, v in node.items():
            _walk(v, spec[k], mesh, path + (str(k),), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for k, v, s in zip(node._fields, node, spec):
            _walk(v, s, mesh, path + (k,), out)
    elif isinstance(node, (list, tuple)):
        for i, (v, s) in enumerate(zip(node, spec)):
            _walk(v, s, mesh, path + (str(i),), out)
    elif isinstance(spec, P):  # a dense matrix held as a block (place_params)
        out.append((path + ("w",), node.w, spec, None))
    else:
        spec = _node_spec(node, spec, mesh)
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, torch.Tensor):
                out.append((path + (f.name,), v, getattr(spec, f.name), (node, spec)))


def _split_axes(spec, mesh) -> tuple:
    """The mesh axes of size > 1 that ``spec`` splits a dim over."""
    return tuple(a for d in spec if d is not None for a in _axes(d) if mesh.size(a) > 1)


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    """A shape-only stand-in for a spec rule: a ``meta`` tensor, made out
    of sight of any active dispatch mode (the dry run's
    ``roofline.StepCounter``), since it holds no storage on any device."""
    from torch.utils._python_dispatch import _disable_current_modes

    with _disable_current_modes():
        return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _global_like(placed: Any) -> Any:
    """The global tree a self-describing placed LM tree was placed from, as
    meta tensors: a ``PasmParams`` takes its arrays' global shapes from its
    logical ``shape`` (a dense block unwrapped to the plain matrix it came
    from); a plain tensor is whole (:func:`place_params` wraps every
    dense matrix it splits)."""
    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(one(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(one(v) for v in node)
        if isinstance(node, torch.Tensor):
            return _meta(node.shape, node.dtype)
        if not isinstance(node, PasmParams):
            return node
        K, N = node.shape

        def _lead(t):
            return tuple(t.shape[:-2]) if node.lead is None else tuple(node.lead)

        if node.kind == "dense" and node.w is not None and node.w.ndim >= 2 \
                and (tuple(node.w.shape[-2:]) != (K, N) or node.lead is not None):
            return _meta(_lead(node.w) + (K, N), node.w.dtype)

        def field(t, rows):
            if t is None or t.ndim < 2:  # a moment's 0-d placeholder
                return None if t is None else _meta(t.shape, t.dtype)
            return _meta(_lead(t) + (rows, N), t.dtype)

        rows = (K + node.pad_k) // 2 if node.packed else K
        return dataclasses.replace(
            node, lead=None, w=field(node.w, K), idx=field(node.idx, rows),
            codebook=None if node.codebook is None else _meta(node.codebook.shape,
                                                             node.codebook.dtype),
            bias=None if node.bias is None else _meta(node.bias.shape, node.bias.dtype))

    return one(placed)


def placed_specs(placed: Any, mesh) -> Any:
    """The spec tree :func:`place_params` placed a self-describing LM tree
    (params, optimizer state, or both) by, recomputed from the global
    shapes its leaves record (:func:`param_pspecs`; a stack whose leading
    dim is split records it in ``PasmParams.lead``).  An optimizer state
    in JAX's ZeRO-1 layout (``train/optimizer.py::ZeroOptState``) takes
    :func:`zero_specs` of the params beside it: the pair ``(params,
    state)`` or ``{"params": .., "opt_state": ..}`` (a train state, as the
    loop and the checkpoints hold it)."""
    from repro_torch.launch.mesh import axis_sizes

    pair = _zero_pair(placed)
    if pair is None:
        if _has_zero(placed):
            raise ValueError("a ZeRO optimizer state's specs follow its params: pass "
                             "the pair (params, state), or specs=")
        return param_pspecs(_global_like(placed), axis_sizes(mesh))
    pk, sk = pair
    keys = placed.keys() if isinstance(placed, dict) else range(len(placed))
    out = {}
    for k in keys:
        if k == sk:
            z = zero_specs(placed[pk], mesh)
            out[k] = type(placed[sk])(P(), z, z)
        else:
            out[k] = placed_specs(placed[k], mesh)
    return out if isinstance(placed, dict) else type(placed)(out[k] for k in keys)


def _is_zero(node: Any) -> bool:
    from repro_torch.train.optimizer import ZeroOptState

    return isinstance(node, ZeroOptState)


def _has_zero(node: Any) -> bool:
    if _is_zero(node):
        return True
    if isinstance(node, dict):
        return any(_has_zero(v) for v in node.values())
    if isinstance(node, (list, tuple)):
        return any(_has_zero(v) for v in node)
    return False


def _zero_pair(node: Any):
    """``(params key, state key)`` of a train state whose optimizer state is
    in the ZeRO layout, else ``None``."""
    if isinstance(node, dict) and _is_zero(node.get("opt_state")) and "params" in node:
        return "params", "opt_state"
    if isinstance(node, (list, tuple)) and not hasattr(node, "_fields") \
            and len(node) >= 2 and _is_zero(node[1]):
        return 0, 1
    return None


# the per-layer (per-group) lists the JAX package stacks on a leading axis
_STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def zero_specs(placed: Any, mesh, specs: Any = None) -> Any:
    """JAX's ZeRO-1 layout of the Adam moments of a placed params tree
    (:func:`opt_state_pspecs` on the global shapes): each moment's largest
    dim that the params' spec leaves whole and ``data`` divides is cut over
    ``data``; a leaf already split over ``data`` (an expert stack's ``Fe``
    block) keeps its spec, and an integer leaf's 0-d moment is whole.

    The rule runs on JAX's stacked shapes, a per-layer leaf with its list's
    length in front.  Where it picks that layer axis (a per-layer vector
    whose one dim ``model`` holds, a small per-layer dictionary), which the
    port's per-layer leaves do not have, the moment is cut within the
    leaf instead, on its largest dim whose block ``data`` divides (inside
    a ``model`` split, ``data`` the inner axis): a rank still holds
    ``1/data`` of it.  ``specs``: the params' placement (default
    :func:`placed_specs`)."""
    from repro_torch.launch.mesh import axis_sizes

    sizes = axis_sizes(mesh)
    nd = sizes.get(DATA, 1)
    specs = placed_specs(placed, mesh) if specs is None else specs

    def one(leaf, spec, n_layers):
        if leaf.ndim == 0:
            return P()
        if not n_layers:
            return opt_state_pspecs(leaf, spec, sizes)
        stacked = _meta((n_layers,) + tuple(leaf.shape))
        z = opt_state_pspecs(stacked, P(None, *spec), sizes)
        if z[0] is None:
            return P(*z[1:])
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        held = [d // _size(a, mesh) if a is not None else d for d, a in zip(leaf.shape, dims)]
        cands = [(h, i) for i, h in enumerate(held) if h % nd == 0 and h >= nd]
        if not cands:
            return P(*dims)
        _, i = max(cands)
        dims[i] = DATA if dims[i] is None else _axes(dims[i]) + (DATA,)
        return P(*dims)

    def walk(node, spec, n_layers, in_list):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return one(node, spec, n_layers)
        if isinstance(node, dict):
            return {k: walk(v, spec[k], len(v) if k in _STACKED and isinstance(v, list)
                            else n_layers, k in _STACKED) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(walk(v, s, n_layers, False) for v, s in zip(node, spec)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s, n_layers if in_list else 0, False)
                              for v, s in zip(node, spec))
        spec = _node_spec(node, spec, mesh)  # a K split place_params left whole
        return dataclasses.replace(node, **{
            f.name: walk(getattr(node, f.name), getattr(spec, f.name), n_layers, False)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})

    like = tree_map(lambda t: t if t.is_floating_point() else _meta(()),
                    global_like(placed, mesh, specs))
    return walk(like, specs, 0, False)


def zero_dims(placed: Any, mesh, specs: Any = None) -> dict:
    """``{path: dim}``: for each float leaf of a placed params tree whose
    ZeRO-1 moment (:func:`zero_specs`) is a block over ``data`` of the
    leaf's own block, the dim it is cut on (absent when ``data`` has one
    rank or the moment is the leaf's block whole)."""
    if mesh.size(DATA) == 1:
        return {}
    specs = placed_specs(placed, mesh) if specs is None else specs
    z = zero_specs(placed, mesh, specs)
    out = {}
    for (path, leaf, ps, _), (_, _, zs, _) in zip(_walked(placed, specs, mesh),
                                                 _walked(placed, z, mesh)):
        if not leaf.is_floating_point():
            continue
        for d, (a, b) in enumerate(zip(tuple(ps) + (None,) * leaf.ndim, zs)):
            if b is not None and DATA in _axes(b) and (a is None or DATA not in _axes(a)):
                out[path] = d
    return out


def _walked(placed: Any, specs: Any, mesh) -> list:
    out: list = []
    _walk(placed, specs, mesh, (), out)
    return out


def _map_logical(placed: Any, specs: Any, mesh, fn) -> Any:
    """``fn(array, spec)`` over a placed tree's arrays, rebuilt in the
    global tree's structure: a dense block that :func:`place_params`
    wrapped comes back as the plain matrix ``fn`` returns."""
    def one(node, spec):
        if node is None:
            return None
        if isinstance(node, torch.Tensor):
            return fn(node, spec)
        if isinstance(node, dict):
            return {k: one(v, spec[k]) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(one(v, s) for v, s in zip(node, spec)))
        if isinstance(node, (list, tuple)):
            return type(node)(one(v, s) for v, s in zip(node, spec))
        if isinstance(spec, P):  # a wrapped dense block: the plain matrix
            return fn(node.w, spec)
        spec = _node_spec(node, spec, mesh)
        out = dataclasses.replace(node, **{
            f.name: fn(getattr(node, f.name), getattr(spec, f.name))
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
        return dataclasses.replace(out, lead=None) if isinstance(out, PasmParams) else out

    return one(placed, specs)


def gather_params(placed: Any, mesh, specs: Any = None) -> Any:
    """The inverse of :func:`place_params` and ``cnn._place``: every
    rank's block of each leaf all-gathered over the axes its spec splits
    it on, so every rank holds the global (logical) tree; a dense block
    that :func:`place_params` wrapped comes back as the plain matrix.
    ``specs`` is the spec tree the tree was placed by (default
    :func:`placed_specs`, for a self-describing LM tree: params, optimizer
    state or both).  A collective: every rank calls it, in step."""
    from repro_torch.launch.mesh import all_gather

    def gather(t, spec):
        with torch.no_grad():
            for dim, ax in enumerate(spec):
                for a in reversed(_axes(ax) if ax is not None else ()):
                    t = all_gather(t, mesh, a, dim=dim)  # the inner axis first
        return t

    specs = placed_specs(placed, mesh) if specs is None else specs
    return _map_logical(placed, specs, mesh, gather)


def global_like(placed: Any, mesh, specs: Any = None) -> Any:
    """The global tree a placed tree was placed from (by ``specs``; default
    :func:`placed_specs`), as meta tensors: each split dim times its axes'
    sizes, a wrapped dense block the plain matrix.  What a restore reads
    the logical arrays into before placing them on this mesh."""
    def grow(t, spec):
        shape = [d * _size(ax, mesh) if ax is not None else d
                 for d, ax in zip(t.shape, tuple(spec) + (None,) * t.ndim)]
        return _meta(shape, t.dtype)

    specs = placed_specs(placed, mesh) if specs is None else specs
    return _map_logical(placed, specs, mesh, grow)


# a whole leaf read on rank-distinct work outside a container, and the
# container whose output block it reads: whisper's MLP bias (``bias1``) is
# narrowed to ``w1``'s column block.  The per-head norm scales act on this
# rank's block of the heads, over ``model`` wherever the heads split into
# blocks (``_heads_split``)
_READ_ON = ((r"(^|/)bias1$", "w1"),)
_PER_HEAD = ("q_norm", "k_norm")


def _main_field(node: Any) -> str:
    """A container's weight array: ``w`` of a dense ``PasmParams``, else
    ``idx``, else a dense conv's ``kernel``."""
    if isinstance(node, PasmParams):
        return "w" if node.kind == "dense" else "idx"
    return "idx" if getattr(node, "idx", None) is not None else "kernel"


def _n_axes(node: Any, spec: Any, mesh) -> tuple:
    """The axes a container's output dim (N; a conv's ``c_out``) splits over."""
    name = _main_field(node)
    t, sa = getattr(node, name), getattr(spec, name)
    if t is None or t.ndim < 2:
        return ()
    n_dim = 0 if t.ndim == 4 else t.ndim - 1  # a conv kernel/idx: c_out first
    return _split_axes(tuple(sa)[n_dim:n_dim + 1], mesh)


def block_axes(placed: Any, mesh, specs: Any = None) -> dict:
    """``{path: axes}``: the mesh axes each leaf of a placed tree holds a
    block over (empty for a leaf held whole), by path
    (:func:`repro_torch.tree.flatten_with_path`).  ``specs`` as in
    :func:`gather_params`."""
    specs = placed_specs(placed, mesh) if specs is None else specs
    return {path: _split_axes(spec, mesh) for path, _, spec, _ in
            _walked(placed, specs, mesh)}


def grad_reduce_axes(placed: Any, mesh, specs: Any = None, *, batch_split: bool = True,
                     reads: dict = None) -> dict:
    """``{path: axes}``: the mesh axes each leaf's gradient is summed over,
    so every rank holds the one-device gradient of its block.

    - ``data`` for every leaf when the batch rows split there
      (``batch_split``): each rank's gradient is its rows' part; but not a
      leaf held as a block over ``data`` (an expert stack's ``Fe`` block:
      a rank runs it on every group's tokens, ``nn/moe.py``);
    - a leaf held whole is also summed over the axes where a rank reads
      only part of it or combines it with its own block: the codebooks of
      a split leaf (``core/qat.py``: a block's bin sums; an expert stack's
      over its E and ``Fe`` blocks), the whole bias an N block narrows
      (``params.tp_linear``; whisper's ``bias1``), a quantized
      vocab-sharded table's codebook, the per-head ``q_norm``/``k_norm``
      where the q heads split into blocks over ``model`` (a rank runs its
      block: ``models/common.py::head_block``; the ranks that share one
      block take disjoint K rows of ``wo``, so each part counts once), and
      what ``reads`` names (``{leaf path: the path of
      the container whose output blocks read it}``: the CNN's per-layer
      QAT codebooks);
    - a leaf held as a block is never summed over the axes it splits on,
      and a whole leaf on replicated work (a norm on the residual stream,
      the MoE router, the SSM's ``A_log``/``dt_bias``/``ssm_D``: their
      rank-distinct consumers take them through ``enter_split``) is the
      same on every rank already.
    """
    specs = placed_specs(placed, mesh) if specs is None else specs
    walked = _walked(placed, specs, mesh)
    n_axes, n_cols = {}, {}  # container (or wrapped block) path -> its N's axes, width
    for path, leaf, spec, owner in walked:
        key = "/".join(path[:-1])
        if owner is not None:
            n_axes[key] = _n_axes(*owner, mesh)
            n_cols[key] = owner[0].shape[-1] if isinstance(owner[0], PasmParams) else None
        elif path[-1] == "w" and len(spec) >= 2:
            n_axes[key] = _split_axes(spec[-1:], mesh)
            n_cols[key] = leaf.shape[-1] * _size(n_axes[key], mesh)
    out = {}
    for path, leaf, spec, owner in walked:
        own = _split_axes(spec, mesh)
        base = ("data",) if batch_split and mesh.size("data") > 1 and "data" not in own \
            else ()
        extra = ()
        if not own:
            name = "/".join(path)
            if owner is not None and path[-1] == "codebook":
                node, nspec = owner
                extra = _split_axes(getattr(nspec, _main_field(node)), mesh)
            elif owner is not None and path[-1] == "bias":
                extra = n_axes["/".join(path[:-1])]
            target = (reads or {}).get(name)
            if path[-1] in _PER_HEAD and target is None:
                extra = (MODEL,) if _heads_split(name, leaf, n_cols, mesh) else ()
            for pat, proj in _READ_ON:
                if target is None and re.search(pat, name):
                    target = re.sub(pat, lambda m, proj=proj: m.group(1) + proj, name)
            if target is not None:
                extra = n_axes.get(target, ())
        out[path] = base + tuple(a for a in extra if a not in base)
    return out


def _heads_split(name: str, norm: torch.Tensor, n_cols: dict, mesh) -> bool:
    """Whether a rank runs its own block of the heads beside the per-head
    norm ``name``: ``wq``'s heads (its width over the norm's ``head_dim``)
    split into more than one block over ``model``
    (``models/common.py::head_groups``, GSPMD's ``gcd(n_heads, model)``).
    Its norm gradient is then its heads' part: the ranks of one block each
    take their own K rows of ``wo``, so their parts are disjoint too."""
    from repro_torch.models.common import head_groups

    width, hd = n_cols.get(re.sub(r"[qk]_norm$", "wq", name)), norm.shape[-1]
    return bool(width) and head_groups(width // hd, mesh.size(MODEL), hd) > 1


_BUCKET_ELEMS = 1 << 20  # a gradient leaf this large is all-reduced alone


def reduce_grads(grads: Any, axes: dict, mesh) -> Any:
    """Each gradient leaf summed over its ``axes[path]``
    (:func:`grad_reduce_axes`), the same sum on every rank.  Leaves that
    share their axes and dtype travel in one flat buffer a group (large
    leaves alone); a leaf with no axes, and ``None`` (an integer leaf),
    come back as they are.  A collective: every rank calls it, in step."""
    from repro_torch.launch.mesh import sum_over

    flat = flatten_with_path(grads)
    out = [g for _, g in flat]
    groups: dict = {}
    for i, (path, g) in enumerate(flat):
        ax = axes[path]
        if not ax:
            continue
        if g.numel() >= _BUCKET_ELEMS:
            out[i] = sum_over(g, mesh, ax)
        else:
            groups.setdefault((ax, g.dtype), []).append(i)
    for (ax, _), idx in groups.items():
        buf = sum_over(torch.cat([out[i].reshape(-1) for i in idx]), mesh, ax)
        for i, part in zip(idx, buf.split([out[i].numel() for i in idx])):
            out[i] = part.view_as(out[i])
    return tree_unflatten(grads, out)



def _mark_seq_shards(caches: Any, specs: Any, n: int) -> Any:
    """Each KV cache whose positions ``specs`` split over ``model`` records
    the ``n`` ranks it splits over (``nn/attention.py``'s ``seq_shards``),
    ``n`` 1 for a whole one."""
    from repro_torch.nn.attention import KVCache, QuantKVCache

    if isinstance(caches, (KVCache, QuantKVCache)):
        k = specs.k if isinstance(caches, KVCache) else specs.k_q
        return dataclasses.replace(caches, seq_shards=n if k[-3] == MODEL else 1)
    if isinstance(caches, dict):
        return {key: _mark_seq_shards(v, specs[key], n) for key, v in caches.items()}
    if isinstance(caches, list):
        return [_mark_seq_shards(v, s, n) for v, s in zip(caches, specs)]
    return caches


def place_caches(cfg, caches: Any, mesh, batch: tuple) -> Any:
    """This rank's block of an LM's caches by :func:`cache_pspecs`: the
    batch over ``batch``'s axes; KV heads over ``model`` when they divide
    it, else the positions (a ring's slots too), which the attention then
    combines over ``model`` (``seq_shards``); the SSM state's head dim, the
    conv windows' and RG-LRU states' channels over ``model``; the counters
    (``pos``, ``slot_pos``) whole."""
    from repro_torch.launch.mesh import axis_sizes

    specs = cache_pspecs(cfg, caches, axis_sizes(mesh), batch)
    placed = tree_map(lambda t, s: _copy_block(t, s, mesh), caches, specs)
    return _mark_seq_shards(placed, specs, mesh.size(MODEL))


def gather_caches(cfg, caches: Any, mesh, batch: tuple, like: Any) -> Any:
    """The inverse of :func:`place_caches`: every rank's block of each leaf
    all-gathered over the axes its spec splits it on, so every rank holds
    the global caches.  ``like`` is the unplaced template (its shapes give
    the specs; ``init_caches(..., device="meta")`` will do).  A collective:
    every rank calls it, in step."""
    from repro_torch.launch.mesh import axis_sizes

    specs = cache_pspecs(cfg, like, axis_sizes(mesh), batch)
    return _mark_seq_shards(gather_params(caches, mesh, specs), specs, 1)
