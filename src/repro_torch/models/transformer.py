"""Decoder-only transformer LM: dense & MoE, GQA (+qk-norm), the vit prefix.

Port of ``repro.models.transformer``: qwen3-32b, nemotron-4-340b,
phi3-medium-14b, stablelm-3b, deepseek-moe-16b, kimi-k2-1t-a32b, and the LM
backbone of internvl2-26b (``frontend="vit"``: projected patch embeddings
prefix the tokens).  Per-layer parameters are a list of per-layer dicts
walked by a Python loop (:func:`maybe_scan`); the MoE family's leading
dense-FFN layers (``first_dense_layers``) are a second list,
``"dense_layers"``, walked first.  PASM quantization swaps any large dense
leaf for a ``PasmParams`` (an expert stack keeps its leading E, each expert
with its own dictionaries) and every matmul dispatches through
:func:`repro_torch.nn.layers.linear` or :mod:`repro_torch.nn.moe`.  The
activations run in bf16, as the JAX package's do; attention goes through
:func:`repro_torch.nn.attention.gqa_attention`, as there.  With
``cfg.remat`` a differentiated :func:`forward` recomputes each scanned
layer in the backward (``torch.utils.checkpoint``, the JAX package's
``jax.checkpoint``).

An active :class:`~repro_torch.models.common.ShardCtx` runs the tensor and
expert parallelism SPMD, one process a rank (the counterpart of the JAX
package's ``ShardCtx(active=True)`` constraints), on params placed by
``models/sharding.py::place_params`` and caches by ``place_caches``::

    mesh = make_conv_mesh((n_data, n_model))          # ("data", "model")
    sctx = ShardCtx.for_mesh(mesh, global_batch=B)
    params = place_params(params, mesh)               # this rank's blocks
    caches = place_caches(cfg, init_caches(cfg, B, S), mesh, sctx.batch)
    logits, caches = prefill(params, tokens, caches, cfg, sctx)  # global

Every rank passes the global inputs and gets the global logits.  The
batch splits over ``data`` where it divides (``batch_axes``); ``wq/wk/wv``,
``w1/w3`` and the head are column-parallel and ``wo``/``w2`` row-parallel
over ``model`` (``params.tp_linear``), so a rank holds its heads
(and their KV group) and its FFN block, and the residual stream is whole
on every rank; the vocab-sharded embedding is looked up on the rank that
holds each row and summed over ``model`` (exact: one nonzero term); the
MoE layers run :func:`repro_torch.nn.moe.moe_ffn` under the mesh.  The
column-parallel linears, the attention and the embedding are bitwise one
device's; a row-parallel sum adds its f32 partials in another order
(within an ulp of bf16).  KV heads that do not divide ``model`` raise
(ROADMAP Queue 1 item 12c).  The dense family's forward under an active
context is differentiable (the collectives carry gradients:
``train/step.py`` trains on it); the MoE and vit families train on one
device only (ROADMAP Queue 1 item 13b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import params as _params
from repro_torch.models.common import Initializer, ShardCtx, map_leaves, maybe_scan
from repro_torch.models.sharding import check_kv_heads
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import moe as M

__all__ = [
    "init_params",
    "forward",
    "init_caches",
    "prefill",
    "decode_step",
]

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(cfg: ArchConfig, ini: Initializer) -> dict:
    D, hd = cfg.d_model, cfg.hd
    dev = ini.gen.device
    p = {
        "wq": ini.dense((D, cfg.n_heads * hd)),
        "wk": ini.dense((D, cfg.n_kv_heads * hd)),
        "wv": ini.dense((D, cfg.n_kv_heads * hd)),
        "wo": ini.dense((cfg.n_heads * hd, D)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), device=dev)
        p["k_norm"] = torch.zeros((hd,), device=dev)
    return p


def _init_dense_ffn(cfg: ArchConfig, ini: Initializer) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    p = {"w1": ini.dense((D, F)), "w2": ini.dense((F, D), fan_in=F)}
    if cfg.act == "swiglu":
        p["w3"] = ini.dense((D, F))
    return p


def _init_moe(cfg: ArchConfig, ini: Initializer) -> dict:
    m = cfg.moe
    D, E, Fe = cfg.d_model, m.n_experts, m.d_expert
    p = {
        "router": ini.dense((D, E)),
        "w1": ini.dense((E, D, Fe), fan_in=D),
        "w3": ini.dense((E, D, Fe), fan_in=D),
        "w2": ini.dense((E, Fe, D), fan_in=Fe),
    }
    if m.n_shared:
        Fs = m.d_shared * m.n_shared
        p["shared_w1"] = ini.dense((D, Fs))
        p["shared_w3"] = ini.dense((D, Fs))
        p["shared_w2"] = ini.dense((Fs, D), fan_in=Fs)
    return p


def _init_layer(cfg: ArchConfig, ini: Initializer, moe: bool = False) -> dict:
    D = cfg.d_model
    dev = ini.gen.device
    p = {
        "attn_norm": torch.zeros((D,), device=dev),
        "ffn_norm": torch.zeros((D,), device=dev),
        "attn": _init_attn(cfg, ini),
    }
    if moe:
        p["moe"] = _init_moe(cfg, ini)
    else:
        p["mlp"] = _init_dense_ffn(cfg, ini)
    return p


def _moe_on(cfg: ArchConfig) -> bool:
    return bool(cfg.moe and cfg.moe.n_experts)


def _n_dense(cfg: ArchConfig) -> int:
    """The MoE family's leading dense-FFN layers (0 for the dense family)."""
    return min(cfg.moe.first_dense_layers, cfg.n_layers) if _moe_on(cfg) else 0


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws: truncated normal at ``fan_in ** -0.5``, embeddings N(0, 0.02²),
    zero norm scales).  Use a CUDA generator for the card."""
    ini = Initializer(gen)
    D, V = cfg.d_model, cfg.vocab
    dev = gen.device
    n_dense = _n_dense(cfg)
    params: dict = {"embed": torch.randn((V, D), generator=gen, device=dev) * 0.02}
    if n_dense:
        params["dense_layers"] = [_init_layer(cfg, ini) for _ in range(n_dense)]
    params["layers"] = [_init_layer(cfg, ini, moe=_moe_on(cfg))
                        for _ in range(cfg.n_layers - n_dense)]
    params["final_norm"] = torch.zeros((D,), device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((D, V))
    if cfg.frontend == "vit":
        params["vproj"] = ini.dense((cfg.frontend_dim, D))
    if dtype != torch.float32:
        params = map_leaves(lambda _, x: x.to(dtype), params)
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _lm_head(params: dict, cfg: ArchConfig, sctx: ShardCtx = ShardCtx()):
    """The ``(D, V)`` head matrix: a tied head dequantizes the embedding once
    and transposes it; an untied head passes its leaf straight to linear.
    A tied head over a vocab-sharded table is this rank's column block of
    the logical ``(D, V)`` head, so ``tp_linear`` reads it as one."""
    if cfg.tie_embeddings:
        w = _params.dense_weight(params["embed"]).T
        if sctx.active and w.shape[-1] != cfg.vocab:
            return _params.PasmParams(w=w, kind="dense", shape=(cfg.d_model, cfg.vocab))
        return w
    return params["lm_head"]


def _lin(x, w, impl: str, sctx: ShardCtx):
    """One linear; under an active context the tensor-parallel dispatch on
    this rank's block, column- or row-parallel as the leaf is placed."""
    if not sctx.active:
        return L.linear(x, w, impl)
    return _params.tp_linear(x, w, impl=impl, mesh=sctx.mesh, rows=sctx.rows(x))


def _heads(t: torch.Tensor, hd: int) -> torch.Tensor:
    """``(B, S, n·hd) → (B, S, n, hd)``: this rank's heads under a mesh."""
    B, S, _ = t.shape
    return t.reshape(B, S, -1, hd)


def _attention_block(x, p, cfg: ArchConfig, sctx: ShardCtx, cos, sin, *,
                     cache=None, impl: str, lengths=None):
    B, S, D = x.shape
    hd = cfg.hd
    q = _heads(_lin(x, p["wq"], impl, sctx), hd)
    k = _heads(_lin(x, p["wk"], impl, sctx), hd)
    v = _heads(_lin(x, p["wv"], impl, sctx), hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    new_cache = None
    if cache is not None:
        quant_cache = isinstance(cache, A.QuantKVCache)
        new_cache = (
            A.update_quant_cache(cache, k, v, lengths=lengths)
            if quant_cache
            else A.update_cache(cache, k, v, lengths=lengths)
        )
        if S == 1:
            o = (A.decode_attention_quant(q, new_cache) if quant_cache
                 else A.decode_attention(q, new_cache))
        else:  # prefill: attend within the freshly written prefix
            o = A.gqa_attention(q, k, v, causal=True, chunk=min(cfg.attn_chunk, S))
    else:
        o = A.gqa_attention(q, k, v, causal=True, chunk=min(cfg.attn_chunk, S))
    y = _lin(o.reshape(B, S, -1), p["wo"], impl, sctx)
    return sctx.act_btd(y), new_cache


def _ffn_block(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str,
               dropless: bool = False) -> tuple:
    """The layer's FFN: routed experts (``"moe"``) or a dense MLP.  Returns
    ``(y, aux)``, ``aux`` the MoE terms (empty when dropless or dense)."""
    B, S, D = x.shape
    if "moe" in p:
        y, aux = M.moe_ffn(x.reshape(B * S, D), p["moe"], cfg.moe, act=cfg.act,
                           impl=impl, dropless=dropless, n_groups=sctx.dp,
                           mesh=sctx.mesh if sctx.active else None,
                           group_spec=sctx.batch if sctx.batch_split else None)
        return sctx.act_btd(y.reshape(B, S, D)), aux
    mp = p["mlp"]
    if cfg.act == "swiglu":
        h = L.swiglu(_lin(x, mp["w1"], impl, sctx), _lin(x, mp["w3"], impl, sctx))
    elif cfg.act == "sq_relu":
        h = L.sq_relu(_lin(x, mp["w1"], impl, sctx))
    else:
        h = L.gelu_ffn_act(_lin(x, mp["w1"], impl, sctx))
    return sctx.act_btd(_lin(sctx.act_btf(h), mp["w2"], impl, sctx)), {}


def _layer_fwd(x, p, cfg, sctx, cos, sin, cache=None, impl="dense", dropless=False,
               lengths=None):
    h, new_cache = _attention_block(
        L.rms_norm(x, p["attn_norm"], cfg.norm_eps), p["attn"], cfg, sctx, cos, sin,
        cache=cache, impl=impl, lengths=lengths,
    )
    x = x + h
    h, aux = _ffn_block(L.rms_norm(x, p["ffn_norm"], cfg.norm_eps), p, cfg, sctx,
                        impl, dropless)
    return x + h, new_cache, aux


def _impl(cfg: ArchConfig) -> str:
    return cfg.quant.impl if cfg.quant.enabled else "dense"


def _head_impl(cfg: ArchConfig) -> str:
    return "dense" if cfg.tie_embeddings else _impl(cfg)


def _embed(w, tokens: torch.Tensor, sctx: ShardCtx) -> torch.Tensor:
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


def _prep_inputs(params, cfg: ArchConfig, sctx: ShardCtx, tokens, frontend_embeds):
    """Token embeddings in bf16, prefixed by the projected patch embeddings
    when the config has a vit frontend and they are given.  Returns ``(x,
    n_prefix)``.  ``vproj`` takes the ``dense`` path even when quantized
    (the JAX package's rule): it dequantizes, and launches no kernel."""
    x = _embed(params["embed"], tokens, sctx).to(torch.bfloat16)
    n_prefix = 0
    if cfg.frontend == "vit" and frontend_embeds is not None:
        pe = L.linear(frontend_embeds.to(torch.bfloat16), params["vproj"], "dense")
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    return sctx.act_btd(x), n_prefix


_AUX_KEYS = ("moe_load_balance", "moe_drop_frac")


def _mine(t, sctx: ShardCtx):
    """This rank's batch rows of a global input (all of them when the batch
    is not split)."""
    if t is None or not sctx.batch_split:
        return t
    from repro_torch.models.sharding import DATA, P, local_shard

    return local_shard(t, P(DATA), sctx.mesh)


def _global_logits(logits: torch.Tensor, cfg: ArchConfig, sctx: ShardCtx) -> torch.Tensor:
    """This rank's logits block → the global logits: the vocab gathered over
    ``model`` (a column-parallel head), then the rows over ``data``."""
    if not sctx.active:
        return logits
    from repro_torch.launch.mesh import all_gather

    if logits.shape[-1] != cfg.vocab:
        logits = all_gather(logits, sctx.mesh, sctx.model, dim=-1)
    if sctx.batch_split:
        logits = all_gather(logits, sctx.mesh, "data", dim=0)
    return logits


def _local_caches(caches: dict, sctx: ShardCtx) -> dict:
    """Placed caches hold this rank's rows of K/V but every slot's counter
    (``cache_pspecs`` replicates ``pos``): the layers take this rank's."""
    if not sctx.batch_split:
        return caches
    return {k: [dataclasses.replace(c, pos=_mine(c.pos, sctx)) for c in v]
            for k, v in caches.items()}


def _global_caches(new: dict, old: dict, sctx: ShardCtx, adv) -> dict:
    """The layers' caches with every slot's counter advanced by ``adv``
    (tokens written: an int, or each slot's real length)."""
    if not sctx.batch_split:
        return new
    return {k: [dataclasses.replace(n, pos=o.pos + (adv if isinstance(adv, int)
                                                     else adv.to(o.pos.dtype)))
                for n, o in zip(new[k], old[k])] for k in new}


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, aux)``;
    ``aux`` holds the MoE terms summed over the scanned layers (zero for
    the dense family).  With ``frontend_embeds`` (vit) the logits cover the
    token positions only: the patch prefix is sliced off."""
    check_kv_heads(cfg, sctx.tp)
    x, n_prefix = _prep_inputs(params, cfg, sctx, _mine(tokens, sctx),
                               _mine(frontend_embeds, sctx))
    B, S, D = x.shape
    cos, sin = L.rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    impl = _impl(cfg)

    for p in params.get("dense_layers", []):
        x = _layer_fwd(x, p, cfg, sctx, cos, sin, impl=impl)[0]

    def layer(h, lp):
        h, _, a = _layer_fwd(h, lp, cfg, sctx, cos, sin, impl=impl)
        return (h,) + tuple(a.get(k, zero) for k in _AUX_KEYS)

    def body(carry, lp):
        h, aux = carry
        if cfg.remat and torch.is_grad_enabled():
            # jax.checkpoint's counterpart: the layer keeps only its input
            # and reruns (K1 included) in the backward
            h, *a = checkpoint(layer, h, lp, use_reentrant=False)
        else:
            h, *a = layer(h, lp)
        return (h, [s + t for s, t in zip(aux, a)]), None

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    (x, aux), _ = maybe_scan(body, (x, [zero] * len(_AUX_KEYS)), params["layers"],
                             cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lin(x, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    if n_prefix:
        logits = logits[:, n_prefix:]
    return _global_logits(logits, cfg, sctx), dict(zip(_AUX_KEYS, aux))


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """One KV cache per layer, on ``device`` (default the card; ``"meta"``
    for shapes only): ``"dense"`` for the MoE family's leading dense layers,
    ``"scan"`` for the rest."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if cfg.quant.enabled and cfg.quant.kv_bits == 8:
        one = lambda: A.init_quant_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd,  # noqa: E731
                                            device=dev)
    else:
        one = lambda: A.init_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd, dtype,  # noqa: E731
                                      device=dev)
    n_dense = _n_dense(cfg)
    return {"dense": [one() for _ in range(n_dense)],
            "scan": [one() for _ in range(cfg.n_layers - n_dense)]}


def decode_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
                sctx: ShardCtx = ShardCtx()) -> tuple:
    """One autoregressive step against the KV caches.  ``tokens (B, 1)``.
    Returns ``(logits, caches)``; RoPE takes each slot's own position."""
    check_kv_heads(cfg, sctx.tp)
    x, _ = _prep_inputs(params, cfg, sctx, _mine(tokens, sctx), None)
    old, caches = caches, _local_caches(caches, sctx)
    # every layer advances in lockstep: the first scanned layer's counters
    # position all slots
    pos = caches["scan"][0].pos
    cos, sin = L.rope(pos, cfg.hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, hd/2): per-slot rope
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        h, nc, _ = _layer_fwd(h, lp, cfg, sctx, cos, sin, cache=cache, impl=impl,
                              dropless=True)
        return h, nc

    x, new_dense = maybe_scan(body, x, list(zip(params.get("dense_layers", []),
                                                caches["dense"])))
    x, new_scan = maybe_scan(body, x, list(zip(params["layers"], caches["scan"])),
                             cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _lin(x, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    new = {"dense": new_dense or [], "scan": new_scan}
    return _global_logits(logits, cfg, sctx), _global_caches(new, old, sctx, 1)


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, lengths: Optional[torch.Tensor] = None,
            frontend_embeds=None) -> tuple:
    """Run the prompt through the model, filling caches.  Returns
    ``(logits, caches)``.

    ``lengths`` (B,) marks each slot's REAL prompt length in a right-padded
    batch: cache counters advance by ``lengths`` (pad rows are never valid
    to decode) and the returned logits are each slot's LAST REAL position.
    ``None`` keeps the full-length semantics (every slot is S tokens).
    With ``frontend_embeds`` (vit) the patch prefix is written to the cache
    ahead of the prompt: the counters advance by ``lengths`` plus the
    prefix.
    """
    check_kv_heads(cfg, sctx.tp)
    x, n_prefix = _prep_inputs(params, cfg, sctx, _mine(tokens, sctx),
                               _mine(frontend_embeds, sctx))
    B, S, D = x.shape
    cos, sin = L.rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    impl = _impl(cfg)
    adv = S if lengths is None else lengths + n_prefix
    eff_lengths = None if lengths is None else _mine(lengths, sctx) + n_prefix
    old, caches = caches, _local_caches(caches, sctx)

    def body(h, inp):
        lp, cache = inp
        h, nc, _ = _layer_fwd(h, lp, cfg, sctx, cos, sin, cache=cache, impl=impl,
                              dropless=True, lengths=eff_lengths)
        return h, nc

    x, new_dense = maybe_scan(body, x, list(zip(params.get("dense_layers", []),
                                                caches["dense"])))
    x, new_scan = maybe_scan(body, x, list(zip(params["layers"], caches["scan"])),
                             cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if eff_lengths is None:
        x_last = x[:, -1:]
    else:
        last = torch.clamp(eff_lengths.long() - 1, 0, S - 1)
        x_last = x[torch.arange(B, device=x.device), last][:, None]
    logits = _lin(x_last, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    new = {"dense": new_dense or [], "scan": new_scan}
    return _global_logits(logits, cfg, sctx), _global_caches(new, old, sctx, adv)
