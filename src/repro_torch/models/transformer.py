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
(within an ulp of bf16).  KV heads that do not divide ``model`` (phi3's 10
at ``model`` 4: a column block of ``wk`` holds 2.5 heads) are gathered
whole, and a rank runs attention on its block of the q heads as GSPMD
splits them (``models/common.py::head_block``: ``gcd(n_heads, model)``
blocks; phi3's 40 at 4, 10 a rank, reading KV heads 0–2, 2–4, ...) and
feeds its K rows of ``wo``; ``cache_pspecs`` then puts the KV cache's
sequence over ``model``, and decode runs every head and combines the
ranks' softmax partials (:func:`repro_torch.nn.attention.decode_attention`).
The dense family's forward under an active context is differentiable
(the collectives carry gradients: ``train/step.py`` trains on it); the MoE
and vit families train on one device only (ROADMAP Queue 1 item 13b).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (Initializer, ShardCtx, embed_tokens, global_logits,
                                       head_block, local_rows, map_leaves, maybe_scan, qkv_heads,
                                       shard_linear, tied_head)
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
    dev = ini.device
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
    dev = ini.device
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


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype=torch.float32, *, device=None) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws: truncated normal at ``fan_in ** -0.5``, embeddings N(0, 0.02²),
    zero norm scales).  Use a CUDA generator for the card.  ``device="meta"``:
    the shapes and dtypes only, no generator needed."""
    ini = Initializer(gen, device)
    D, V = cfg.d_model, cfg.vocab
    dev = ini.device
    n_dense = _n_dense(cfg)
    params: dict = {"embed": ini.normal((V, D)) * 0.02}
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
    and transposes it (:func:`~repro_torch.models.common.tied_head`); an
    untied head passes its leaf straight to linear."""
    if cfg.tie_embeddings:
        return tied_head(params["embed"], cfg, sctx)
    return params["lm_head"]


def _attention_block(x, p, cfg: ArchConfig, sctx: ShardCtx, cos, sin, *,
                     cache=None, impl: str, lengths=None):
    B, S, D = x.shape
    hb = head_block(cfg, sctx, decode=cache is not None and S == 1)
    q, k, v = qkv_heads(x, x, p, cfg, sctx, impl, hb)
    mesh = sctx.mesh if sctx.active else None
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    new_cache = None
    if cache is not None:
        quant_cache = isinstance(cache, A.QuantKVCache)
        new_cache = (
            A.update_quant_cache(cache, k, v, lengths=lengths, mesh=mesh)
            if quant_cache
            else A.update_cache(cache, k, v, lengths=lengths, mesh=mesh)
        )
        if S == 1:
            o = (A.decode_attention_quant(q, new_cache, mesh=mesh) if quant_cache
                 else A.decode_attention(q, new_cache, mesh=mesh))
        else:  # prefill: attend within the freshly written prefix
            o = A.gqa_attention(q, *hb.kv(k, v), causal=True, chunk=min(cfg.attn_chunk, S))
    else:
        o = A.gqa_attention(q, *hb.kv(k, v), causal=True, chunk=min(cfg.attn_chunk, S))
    y = shard_linear(hb.out(o), p["wo"], impl, sctx)
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
        h = L.swiglu(shard_linear(x, mp["w1"], impl, sctx), shard_linear(x, mp["w3"], impl, sctx))
    elif cfg.act == "sq_relu":
        h = L.sq_relu(shard_linear(x, mp["w1"], impl, sctx))
    else:
        h = L.gelu_ffn_act(shard_linear(x, mp["w1"], impl, sctx))
    return sctx.act_btd(shard_linear(sctx.act_btf(h), mp["w2"], impl, sctx)), {}


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


# the activations' dtype, bf16 as in the JAX package
_ACT = torch.bfloat16


def _prep_inputs(params, cfg: ArchConfig, sctx: ShardCtx, tokens, frontend_embeds):
    """Token embeddings in bf16, prefixed by the projected patch embeddings
    when the config has a vit frontend and they are given.  Returns ``(x,
    n_prefix)``.  ``vproj`` takes the ``dense`` path even when quantized
    (the JAX package's rule): it dequantizes, and launches no kernel."""
    x = embed_tokens(params["embed"], tokens, sctx).to(_ACT)
    n_prefix = 0
    if cfg.frontend == "vit" and frontend_embeds is not None:
        pe = L.linear(frontend_embeds.to(_ACT), params["vproj"], "dense")
        x = torch.cat([pe, x], dim=1)
        n_prefix = pe.shape[1]
    return sctx.act_btd(x), n_prefix


_AUX_KEYS = ("moe_load_balance", "moe_drop_frac")


def _local_caches(caches: dict, sctx: ShardCtx) -> dict:
    """Placed caches hold this rank's rows of K/V but every slot's counter
    (``cache_pspecs`` replicates ``pos``): the layers take this rank's."""
    if not sctx.batch_split:
        return caches
    return {k: [dataclasses.replace(c, pos=local_rows(c.pos, sctx)) for c in v]
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
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None,
            logits_block: bool = False) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, aux)``;
    ``aux`` holds the MoE terms summed over the scanned layers (zero for
    the dense family).  With ``frontend_embeds`` (vit) the logits cover the
    token positions only: the patch prefix is sliced off.  Under an active
    ``sctx`` the logits are global on every rank, or with ``logits_block``
    this rank's block of them (``common.global_logits``)."""
    x, n_prefix = _prep_inputs(params, cfg, sctx, local_rows(tokens, sctx),
                               local_rows(frontend_embeds, sctx))
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
    logits = shard_linear(x, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    if n_prefix:
        logits = logits[:, n_prefix:]
    return global_logits(logits, cfg, sctx, block=logits_block), dict(zip(_AUX_KEYS, aux))


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
    x, _ = _prep_inputs(params, cfg, sctx, local_rows(tokens, sctx), None)
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
    logits = shard_linear(x, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    new = {"dense": new_dense or [], "scan": new_scan}
    return global_logits(logits, cfg, sctx), _global_caches(new, old, sctx, 1)


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
    x, n_prefix = _prep_inputs(params, cfg, sctx, local_rows(tokens, sctx),
                               local_rows(frontend_embeds, sctx))
    B, S, D = x.shape
    cos, sin = L.rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    impl = _impl(cfg)
    adv = S if lengths is None else lengths + n_prefix
    eff_lengths = None if lengths is None else local_rows(lengths, sctx) + n_prefix
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
    logits = shard_linear(x_last, _lm_head(params, cfg, sctx), _head_impl(cfg), sctx)
    new = {"dense": new_dense or [], "scan": new_scan}
    return global_logits(logits, cfg, sctx), _global_caches(new, old, sctx, adv)
