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
:func:`input_pspecs`) are ported with their rules; the transformer
families' tensor and expert parallelism (an active ``ShardCtx``) runs on
params placed by :func:`param_pspecs` (:func:`place_params`) and caches
placed by :func:`cache_pspecs` (:func:`place_caches`).

:func:`local_shard` is the port's own: ``jax.device_put`` onto a
``NamedSharding`` keeps a global array whose blocks live on the devices;
under SPMD a rank holds its block, and this slices it out.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any

import torch

from repro_torch.core.params import NOT_PORTED_MESH_SEQ, PasmParams
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
    "place_caches",
    "check_kv_heads",
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


def _place_node(node: Any, spec: Any, mesh) -> Any:
    if isinstance(node, dict):
        return {k: _place_node(v, spec[k], mesh) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_place_node(v, s, mesh) for v, s in zip(node, spec))
    if isinstance(node, PasmParams):
        a = node.w if node.kind == "dense" else node.idx
        sa = spec.w if node.kind == "dense" else spec.idx
        k_ax = sa[a.ndim - 2] if len(sa) >= 2 else None
        if k_ax is not None and node.groups > 1 and node.groups % _size(k_ax, mesh):
            # a K split would cut a dictionary group: the leaf stays whole
            spec = tree_map(lambda t: P(*([None] * t.ndim)), node)
        return dataclasses.replace(node, **{
            f.name: _copy_block(getattr(node, f.name), getattr(spec, f.name), mesh)
            for f in dataclasses.fields(node)
            if isinstance(getattr(node, f.name), torch.Tensor)})
    if not isinstance(node, torch.Tensor):
        return node
    block = _copy_block(node, spec, mesh)
    if node.ndim >= 2 and tuple(block.shape[-2:]) != tuple(node.shape[-2:]):
        # a dense matrix held as a block keeps its logical shape, as a
        # quantized leaf does (params.tp_linear reads the block off it)
        return PasmParams(w=block, kind="dense", shape=tuple(node.shape[-2:]))
    return block


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

    return _place_node(params, param_pspecs(params, axis_sizes(mesh)), mesh)


def check_kv_heads(cfg, tp: int) -> None:
    """Raise unless the KV heads divide a ``model`` axis of size ``tp``:
    otherwise :func:`cache_pspecs` shards the sequence, which needs a
    distributed softmax (ROADMAP Queue 1 item 12c)."""
    if tp > 1 and (not cfg.n_kv_heads or cfg.n_kv_heads % tp):
        raise NotImplementedError(NOT_PORTED_MESH_SEQ)


def place_caches(cfg, caches: Any, mesh, batch: tuple) -> Any:
    """This rank's block of the KV caches by :func:`cache_pspecs`: the
    batch over ``batch``'s axes, the KV heads over ``model`` (the per-slot
    counters ``pos`` replicated).  KV heads that do not divide ``model``
    take :func:`cache_pspecs`' sequence-sharded branch, which needs a
    distributed softmax: that raises (ROADMAP Queue 1 item 12c)."""
    from repro_torch.launch.mesh import axis_sizes

    check_kv_heads(cfg, mesh.size(MODEL))
    specs = cache_pspecs(cfg, caches, axis_sizes(mesh), batch)
    return tree_map(lambda t, s: _copy_block(t, s, mesh), caches, specs)
