"""Model-layer plumbing: init helpers, the layer loop, PASM param surgery.

Port of ``repro.models.common``.  Init draws from an explicit
``torch.Generator``; the two packages draw different numbers from the same
seed, so the tests carry weights across with :mod:`repro_torch.interop`.

Parameter trees are plain dicts and lists of tensors: per-layer parameters
are a list of per-layer dicts (the JAX package stacks them on a leading
axis for ``lax.scan``), and :func:`maybe_scan` is the Python loop over
them.  :func:`quantize_params` swaps large dense leaves for
:class:`~repro_torch.core.params.PasmParams` with the JAX package's rule.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import params as _params
from repro_torch.core import pasm as _pasm
from repro_torch.nn import layers as L

__all__ = [
    "ShardCtx",
    "shard_linear",
    "whole_cols",
    "block_of",
    "conv_weight",
    "kv_heads_split",
    "head_groups",
    "HeadBlock",
    "head_block",
    "proj_heads",
    "qkv_heads",
    "local_rows",
    "whole_rows",
    "embed_tokens",
    "tied_head",
    "global_logits",
    "trunc_normal",
    "Initializer",
    "maybe_scan",
    "map_leaves",
    "quantize_params",
    "param_count",
    "weight_bytes",
]

# either weight-shared container counts as one leaf
_CONTAINERS = (_params.PasmParams, _pasm.PASMTensor)


def trunc_normal(gen: Optional[torch.Generator], shape, std, dtype=torch.float32, *,
                 device=None) -> torch.Tensor:
    """Standard normal truncated to ``[-2, 2]``, times ``std``, drawn on the
    generator's device (or on ``device``: ``"meta"`` draws nothing)."""
    dev = gen.device if device is None else device
    t = torch.empty(tuple(shape), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=gen)
    return (t * std).to(dtype)


class Initializer:
    """Draws every init from one generator, so init code reads linearly.

    ``device="meta"`` builds shapes and dtypes only, with no generator and
    no draws: the port's ``jax.eval_shape`` of an ``init_params`` (the dry
    run's trees).  Otherwise everything lands on the generator's device."""

    def __init__(self, gen: Optional[torch.Generator], device=None):
        meta = device is not None and torch.device(device).type == "meta"
        self.gen = None if meta else gen
        self.device = torch.device("meta") if meta else gen.device

    def dense(self, shape, fan_in=None, dtype=torch.float32) -> torch.Tensor:
        fan_in = fan_in or shape[0]
        return trunc_normal(self.gen, shape, fan_in ** -0.5, dtype, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """Standard normal draws of ``shape``, f32."""
        return torch.randn(tuple(shape), generator=self.gen, device=self.device)


def maybe_scan(body: Callable, carry, stacked, use_scan: bool = True):
    """The port's ``lax.scan``: a Python loop of ``body(carry, item)`` over
    the per-layer items of ``stacked``.  Returns ``(carry, ys)``, ``ys`` the
    list of per-step outputs (None when the body emits None).  ``use_scan``
    is kept for signature parity: the JAX package's scanned and unrolled
    forms are the same loop here."""
    del use_scan
    ys = []
    for item in stacked:
        carry, y = body(carry, item)
        ys.append(y)
    return carry, (ys if ys and ys[0] is not None else None)


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Mesh-axis naming threaded through model code.

    ``batch``: the axes the batch dim shards over (``("data",)`` or ``()``,
    :func:`repro_torch.models.sharding.batch_axes`); ``model``: the
    tensor-parallel axis; ``dp``: the DP degree, the product of the batch
    axes' sizes (the MoE's local dispatch groups).  ``active=False`` (the
    default) is one device.

    An active context runs every LM family's tensor parallelism (and the
    MoE family's expert parallelism) SPMD, one process a rank, on the
    ``("data", "model")``
    :class:`~repro_torch.launch.mesh.Mesh` it carries: the JAX package reads
    its ambient mesh, the port takes it as ``mesh=``.  Layouts are explicit
    there (placed params and caches, rank-local activations), so the
    layout hooks stay the identity.  :meth:`for_mesh` builds the context
    the JAX package's dry run builds for a global batch.
    """

    batch: tuple = ("data",)
    model: str = "model"
    active: bool = False
    dp: int = 1
    mesh: Optional[Any] = None

    def __post_init__(self):
        if not self.active:
            return
        if self.mesh is None:
            raise ValueError(
                "an active ShardCtx runs SPMD on an explicit mesh: pass mesh= "
                "(repro_torch.launch.mesh.make_conv_mesh((n_data, n_model)))")
        from repro_torch.launch.mesh import data_model_sizes

        nd, _ = data_model_sizes(self.mesh)
        if self.model != "model" or tuple(self.batch) not in ((), ("data",)):
            raise ValueError(f"batch {self.batch} / model {self.model!r} do not name "
                             "the ('data', 'model') mesh's axes")
        if self.dp != (nd if self.batch else 1):
            raise ValueError(f"dp={self.dp} is not the size of the batch axes "
                             f"{self.batch} (data: {nd})")

    @classmethod
    def for_mesh(cls, mesh, global_batch: int) -> "ShardCtx":
        """The active context for ``global_batch`` rows on ``mesh``: the
        batch over ``data`` when it divides, else replicated (dp 1)."""
        from repro_torch.launch.mesh import data_model_sizes
        from repro_torch.models.sharding import batch_axes

        nd, _ = data_model_sizes(mesh)
        batch = batch_axes(False, global_batch, nd)
        return cls(batch=batch, active=True, dp=nd if batch else 1, mesh=mesh)

    @property
    def tp(self) -> int:
        """Ranks along ``model`` (1 when inactive)."""
        return self.mesh.size(self.model) if self.active else 1

    @property
    def batch_split(self) -> bool:
        """Whether a rank holds only its block of the batch rows."""
        return self.active and bool(self.batch) and self.dp > 1

    def rows(self, x: torch.Tensor) -> int:
        """Rows of the unsharded call behind ``x`` (this rank's rows)."""
        return x.numel() // max(x.shape[-1], 1) * (self.dp if self.batch_split else 1)

    def cs(self, x: torch.Tensor, *spec) -> torch.Tensor:
        return x

    def act_btd(self, x):  # (batch, seq, d_model)
        return x

    def act_bthd(self, x):  # (batch, seq, heads, hd)
        return x

    def act_btf(self, x):  # (batch, seq, ff)
        return x


# ---------------------------------------------------------------------------
# the SPMD pieces every LM family shares under an active context: params
# placed by models/sharding.py::place_params, activations rank-local
# ---------------------------------------------------------------------------


def shard_linear(x: torch.Tensor, w, impl: str, sctx: ShardCtx) -> torch.Tensor:
    """One linear; under an active context the tensor-parallel dispatch on
    this rank's block (``params.tp_linear``), column- or row-parallel as
    the leaf is placed: an N block gives this rank's output columns, a K
    block takes ``x`` whole or as its own K block and sums over ``model``."""
    if not sctx.active:
        return L.linear(x, w, impl)
    return _params.tp_linear(x, w, impl=impl, mesh=sctx.mesh, rows=sctx.rows(x))


def whole_cols(y: torch.Tensor, n: int, sctx: ShardCtx) -> torch.Tensor:
    """``y`` with its last dim whole (``n``): a column-parallel output held
    as this rank's block is all-gathered over ``model`` (bitwise the
    unsharded columns), counted as ``relayout``: the block does not line
    up with what the next step needs.  A whole ``y`` comes back as is."""
    if not sctx.active or y.shape[-1] == n:
        return y
    from repro_torch.launch.mesh import all_gather

    return all_gather(y, sctx.mesh, sctx.model, dim=-1, key="relayout")


def block_of(n: int, held: int, sctx: ShardCtx) -> slice:
    """The slice of a dim of ``n`` that this rank's ``held`` entries are: its
    contiguous block along ``model`` (all of it when held whole)."""
    if held == n:
        return slice(0, n)
    start = sctx.mesh.index(sctx.model) * held
    return slice(start, start + held)


def conv_weight(p: dict) -> torch.Tensor:
    """A layer's depthwise conv weight as it holds it: under a mesh its
    channel block, which ``place_params`` keeps as a ``dense``
    ``PasmParams`` of the logical shape."""
    return _params.dense_weight(p["conv_w"])


def kv_heads_split(cfg: ArchConfig, sctx: ShardCtx) -> bool:
    """Whether a rank holds its own KV heads: they divide ``model``
    (``cache_pspecs`` then puts the KV cache's heads over ``model``, else
    its positions)."""
    return sctx.active and sctx.tp > 1 and bool(cfg.n_kv_heads) \
        and cfg.n_kv_heads % sctx.tp == 0


def head_groups(n_heads: int, tp: int, hd: int) -> int:
    """The blocks the q heads split into over ``tp`` ranks of ``model``:
    ``gcd(n_heads, tp)``, as GSPMD splits a ``(.., "model", ..)`` heads
    constraint that ``model`` does not divide (40 heads over 16: 8 blocks
    of 5, each held by 2 consecutive ranks).  1 (every rank runs every
    head) where a rank's share of its block's output columns,
    ``n_heads·hd / tp``, is not whole."""
    import math

    g = math.gcd(n_heads, tp) if n_heads and tp > 1 else 1
    return g if g > 1 and (n_heads * hd) % tp == 0 else 1


@dataclasses.dataclass(frozen=True)
class HeadBlock:
    """This rank's attention heads (:func:`head_block`): q heads ``[q0, q0 +
    nq)``, block ``q0 // nq`` of ``g``, and the KV heads they read.

    ``kv_sel`` picks those KV heads out of k and v as the rank holds them:
    ``None`` (the rank's own KV block, or every head on one device), a
    slice (the block's q heads cover whole KV groups from a group's start,
    or sit inside one), or the KV head of each q head (they straddle a
    group: attention then runs one KV head a q head).  ``o_cols`` is the
    slice of the block's ``nq·hd`` output columns this rank's K rows of
    ``wo`` take (``None``: all of them, or the whole output on every
    rank)."""

    g: int
    q0: int
    nq: int
    kv_split: bool
    kv_sel: Any = None
    o_cols: Optional[slice] = None

    def kv(self, *ts: torch.Tensor) -> tuple:
        """The KV heads of this block from each ``(B, S, KV, hd)`` in ``ts``."""
        if self.kv_sel is None:
            return ts
        if isinstance(self.kv_sel, slice):
            return tuple(t[:, :, self.kv_sel] for t in ts)
        idx = torch.tensor(self.kv_sel, device=ts[0].device)
        return tuple(t.index_select(2, idx) for t in ts)

    def out(self, o: torch.Tensor) -> torch.Tensor:
        """The block's attention output ``(..., nq, hd)`` as the input of
        ``wo``'s row-parallel ``shard_linear``: this rank's K block of it
        (the whole output when every rank runs every head)."""
        o = o.reshape(*o.shape[:-2], -1)
        return o if self.o_cols is None else o[..., self.o_cols]


def head_block(cfg: ArchConfig, sctx: ShardCtx, *, decode: bool = False) -> HeadBlock:
    """Where this rank's attention heads are: JAX constrains q to
    ``(batch, None, model, None)`` and k, v to ``(batch, None, None,
    None)``, and GSPMD cuts the q heads into ``g = gcd(n_heads, model)``
    blocks (:func:`head_groups`), block ``i`` on ranks ``i·model/g`` to
    ``(i+1)·model/g − 1``.  Where the KV heads divide ``model`` this is
    each rank's own q and KV heads.  ``decode`` (one token against a cache
    whose positions split over ``model`` where the KV heads do not) gives
    every rank every head, whose softmax partials it combines over
    ``model`` (``nn/attention.py``).  Inactive, or at ``tp`` 1: one
    device's."""
    tp = sctx.tp
    H, hd = cfg.n_heads, cfg.hd
    kv_split = kv_heads_split(cfg, sctx)
    g = 1 if decode and not kv_split else head_groups(H, tp, hd)
    if g == 1:
        return HeadBlock(1, 0, H, kv_split)
    rank, per = sctx.mesh.index(sctx.model), tp // g
    nq = H // g
    q0 = rank // per * nq
    o_cols = None
    if per > 1:
        w = nq * hd // per
        o_cols = slice(rank % per * w, (rank % per + 1) * w)
    if kv_split:
        return HeadBlock(g, q0, nq, True, None, o_cols)
    G = H // cfg.n_kv_heads
    kv = tuple(h // G for h in range(q0, q0 + nq))
    n = kv[-1] - kv[0] + 1
    run = nq // n if nq % n == 0 else 0
    if run and all(kv[i] == kv[0] + i // run for i in range(nq)):
        sel = slice(kv[0], kv[-1] + 1)
    else:
        sel = kv
    return HeadBlock(g, q0, nq, False, sel, o_cols)


def proj_heads(x, w, n: int, cfg: ArchConfig, sctx: ShardCtx, impl: str,
               hb: Optional[HeadBlock] = None, *, query: bool = False) -> torch.Tensor:
    """``x`` through the column-parallel ``w`` as ``(..., heads, hd)`` of
    ``n`` heads, for the rank's head block ``hb`` (default
    :func:`head_block`): the queries (``query``) as the block's heads, keys
    and values as the cache holds them, the rank's own KV heads where they
    split and else every KV head (:meth:`HeadBlock.kv` takes the block's).
    A column block that is not what the block needs is gathered whole over
    ``model`` (it may cut a head); where the gathered tensor then feeds the
    rank's own heads it passes ``enter_split``, so its gradient is summed
    over ``model`` before the rank takes its block back."""
    hb = head_block(cfg, sctx) if hb is None else hb
    hd = cfg.hd
    y = shard_linear(x, w, impl, sctx)
    own = (hb.g == sctx.tp and y.shape[-1] == hb.nq * hd) if query else hb.kv_split
    if not own:
        y = whole_cols(y, n * hd, sctx)
        if hb.g > 1:
            from repro_torch.launch.mesh import enter_split

            y = enter_split(y, sctx.mesh, sctx.model)
            if query:
                y = y[..., hb.q0 * hd:(hb.q0 + hb.nq) * hd]
    return y.reshape(*y.shape[:-1], -1, hd)


def qkv_heads(xq, xkv, p: dict, cfg: ArchConfig, sctx: ShardCtx, impl: str,
              hb: Optional[HeadBlock] = None) -> tuple:
    """The attention heads ``(q, k, v)`` (:func:`proj_heads`) of ``xq``
    (queries) and ``xkv`` (keys and values) through ``p``'s ``wq/wk/wv``,
    for the head block ``hb``."""
    hb = head_block(cfg, sctx) if hb is None else hb
    return (proj_heads(xq, p["wq"], cfg.n_heads, cfg, sctx, impl, hb, query=True),
            proj_heads(xkv, p["wk"], cfg.n_kv_heads, cfg, sctx, impl, hb),
            proj_heads(xkv, p["wv"], cfg.n_kv_heads, cfg, sctx, impl, hb))


def local_rows(t, sctx: ShardCtx):
    """This rank's batch rows of a global input (all of them when the batch
    is not split)."""
    if t is None or not sctx.batch_split:
        return t
    from repro_torch.models.sharding import DATA, P, local_shard

    return local_shard(t, P(DATA), sctx.mesh)


def whole_rows(t: torch.Tensor, sctx: ShardCtx, key: str = "cache_rows") -> torch.Tensor:
    """Every rank's rows of ``t`` gathered over ``data``: by default a
    recurrent state ``cache_pspecs`` keeps whole on the batch, after a rank
    updated its own rows (counted under ``key``)."""
    if not sctx.batch_split:
        return t
    from repro_torch.launch.mesh import all_gather

    return all_gather(t, sctx.mesh, "data", dim=0, key=key)


def embed_tokens(w, tokens: torch.Tensor, sctx: ShardCtx) -> torch.Tensor:
    """The embedding rows of ``tokens``.  A vocab-sharded table (under a
    mesh) looks up the rows this rank holds, zeros elsewhere, and sums over
    ``model``: one nonzero term per element, so exact."""
    if sctx.active:
        held, split = _params.held_block(w, sctx.mesh)
        if split:
            from repro_torch.launch.mesh import all_reduce

            n = held.shape[0]
            loc = tokens - sctx.mesh.index(sctx.model) * n
            own = (loc >= 0) & (loc < n)
            rows = _params.embed_lookup(w, torch.where(own, loc, torch.zeros_like(loc)))
            rows = torch.where(own[..., None], rows, torch.zeros_like(rows))
            return all_reduce(rows, sctx.mesh, sctx.model)
    return _params.embed_lookup(w, tokens)


def tied_head(embed, cfg: ArchConfig, sctx: ShardCtx):
    """The ``(D, V)`` head of a tied embedding: dequantized once and
    transposed.  Over a vocab-sharded table it is this rank's column block
    of the logical ``(D, V)`` head, so ``tp_linear`` reads it as one."""
    w = _params.dense_weight(embed).T
    if sctx.active and w.shape[-1] != cfg.vocab:
        return _params.PasmParams(w=w, kind="dense", shape=(cfg.d_model, cfg.vocab))
    return w


def global_logits(logits: torch.Tensor, cfg: ArchConfig, sctx: ShardCtx, *,
                  block: bool = False) -> torch.Tensor:
    """This rank's logits block → the global logits: the vocab gathered over
    ``model`` (a column-parallel head), then the rows over ``data``.  With
    ``block`` (a family's ``forward(logits_block=True)``, what the train
    step's ``api.sharded_lm_loss`` reads) the block comes back as is."""
    if block or not sctx.active:
        return logits
    from repro_torch.launch.mesh import all_gather

    if logits.shape[-1] != cfg.vocab:
        logits = all_gather(logits, sctx.mesh, sctx.model, dim=-1)
    if sctx.batch_split:
        logits = all_gather(logits, sctx.mesh, "data", dim=0)
    return logits


def map_leaves(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (a weight-shared container is one leaf); returns the same structure."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _leaves(tree: Any) -> list:
    out = []
    map_leaves(lambda _, x: out.append(x), tree)
    return out


def param_count(params: Any) -> int:
    """Logical parameter count (PASM leaves count their dense size)."""
    n = 0
    for leaf in _leaves(params):
        if isinstance(leaf, _CONTAINERS):
            p = _params.as_params(leaf)
            lead = 1
            for d in p._lead:
                lead *= int(d)
            n += lead * int(p.shape[0]) * int(p.shape[1])
        elif isinstance(leaf, torch.Tensor):
            n += leaf.numel()
    return n


# ---------------------------------------------------------------------------
# PASM parameter surgery: replace selected dense leaves with PasmParams
# ---------------------------------------------------------------------------

_EXCLUDE = re.compile(
    r"(norm|scale|bias|router|lam|A_log|ssm_D|dt_bias|conv|pos_embed)", re.IGNORECASE
)


def quantize_params(params: Any, cfg: ArchConfig, *, iters: int = 8) -> Any:
    """Apply the paper's weight-sharing to a model's parameter tree.

    Quantizes every ≥2-D dense leaf whose trailing ``(K, N)`` matrix has at
    least ``cfg.quant.min_weight_elems`` elements (the paper's ``B ≪ N``
    rule) and which is not an excluded parameter class (norms, biases,
    routers… stay dense, paper §4; embeddings unless ``quantize_embed``).
    Each layer's matrix, and each expert's in a stack, gets its own
    dictionary, as the JAX package's per-slice quantization does; 16-bin (int4) dictionaries are packed, with the §3
    K-pad for odd reductions.  k-means runs on the leaf's device.
    """
    q = cfg.quant
    if not q.enabled:
        return params

    def maybe_quantize(path, leaf):
        name = "/".join(path)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        if leaf.ndim < 2 or _EXCLUDE.search(name):
            return leaf
        if "embed" in name.lower() and not q.quantize_embed:
            return leaf
        K, N = leaf.shape[-2], leaf.shape[-1]
        if K * N < q.min_weight_elems:
            return leaf
        p = _params.PasmParams.quantize(leaf, q.bins, groups=q.groups, iters=iters)
        if _pasm.bits_for_bins(q.bins) == 4:
            p = p.pack()
        return p

    return map_leaves(maybe_quantize, params)


def weight_bytes(params: Any, dense_dtype_bytes: int = 2) -> dict:
    """Device-memory weight bytes: dense vs PASM-stored."""
    dense = 0
    stored = 0
    for leaf in _leaves(params):
        if isinstance(leaf, _CONTAINERS):
            p = _params.as_params(leaf)
            lead = 1
            for d in p._lead:
                lead *= int(d)
            dense += lead * int(p.shape[0]) * int(p.shape[1]) * dense_dtype_bytes
            stored += p.nbytes_weights
        elif isinstance(leaf, torch.Tensor):
            dense += leaf.numel() * dense_dtype_bytes
            stored += leaf.numel() * dense_dtype_bytes
    return {"dense": dense, "stored": stored, "ratio": dense / max(stored, 1)}
