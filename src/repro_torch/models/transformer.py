"""Decoder-only transformer LM: the dense family, GQA (+qk-norm).

Port of ``repro.models.transformer`` for the dense archs (qwen3-32b,
nemotron-4-340b, phi3-medium-14b, stablelm-3b).  Per-layer parameters are a
list of per-layer dicts walked by a Python loop (:func:`maybe_scan`); PASM
quantization swaps any large dense leaf for a ``PasmParams`` and every
matmul dispatches through :func:`repro_torch.nn.layers.linear`.  The
activations run in bf16, as the JAX package's do; attention goes through
:func:`repro_torch.nn.attention.gqa_attention`, as there.  With
``cfg.remat`` a differentiated :func:`forward` recomputes each layer in the
backward (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``).

Configs with ``moe`` experts or a ``vit`` frontend raise
``NotImplementedError``: their modules come with ROADMAP Queue 1 item 8.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import params as _params
from repro_torch.models.common import Initializer, ShardCtx, map_leaves, maybe_scan
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L

__all__ = [
    "init_params",
    "forward",
    "init_caches",
    "prefill",
    "decode_step",
]

NOT_PORTED_MOE_VIT = (
    "MoE experts and the vit frontend are not ported yet: ROADMAP Queue 1 "
    "item 8 (LM families: nn/moe.py and the vit prefix)"
)


def _check_ported(cfg: ArchConfig) -> None:
    if (cfg.moe and cfg.moe.n_experts) or cfg.frontend == "vit":
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED_MOE_VIT}")


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


def _init_layer(cfg: ArchConfig, ini: Initializer) -> dict:
    D = cfg.d_model
    dev = ini.gen.device
    return {
        "attn_norm": torch.zeros((D,), device=dev),
        "ffn_norm": torch.zeros((D,), device=dev),
        "attn": _init_attn(cfg, ini),
        "mlp": _init_dense_ffn(cfg, ini),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws: truncated normal at ``fan_in ** -0.5``, embeddings N(0, 0.02²),
    zero norm scales).  Use a CUDA generator for the card."""
    _check_ported(cfg)
    ini = Initializer(gen)
    D, V = cfg.d_model, cfg.vocab
    dev = gen.device
    params: dict = {
        "embed": torch.randn((V, D), generator=gen, device=dev) * 0.02,
        "layers": [_init_layer(cfg, ini) for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros((D,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = ini.dense((D, V))
    if dtype != torch.float32:
        params = map_leaves(lambda _, x: x.to(dtype), params)
    return params


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------


def _lm_head(params: dict, cfg: ArchConfig):
    """The ``(D, V)`` head matrix: a tied head dequantizes the embedding once
    and transposes it; an untied head passes its leaf straight to linear."""
    if cfg.tie_embeddings:
        return _params.dense_weight(params["embed"]).T
    return params["lm_head"]


def _attention_block(x, p, cfg: ArchConfig, sctx: ShardCtx, cos, sin, *,
                     cache=None, impl: str, lengths=None):
    B, S, D = x.shape
    hd = cfg.hd
    q = L.linear(x, p["wq"], impl).reshape(B, S, cfg.n_heads, hd)
    k = L.linear(x, p["wk"], impl).reshape(B, S, cfg.n_kv_heads, hd)
    v = L.linear(x, p["wv"], impl).reshape(B, S, cfg.n_kv_heads, hd)
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
    y = L.linear(o.reshape(B, S, cfg.n_heads * hd), p["wo"], impl)
    return sctx.act_btd(y), new_cache


def _ffn_block(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str):
    mp = p["mlp"]
    if cfg.act == "swiglu":
        h = L.swiglu(L.linear(x, mp["w1"], impl), L.linear(x, mp["w3"], impl))
    elif cfg.act == "sq_relu":
        h = L.sq_relu(L.linear(x, mp["w1"], impl))
    else:
        h = L.gelu_ffn_act(L.linear(x, mp["w1"], impl))
    return sctx.act_btd(L.linear(sctx.act_btf(h), mp["w2"], impl))


def _layer_fwd(x, p, cfg, sctx, cos, sin, cache=None, impl="dense", lengths=None):
    h, new_cache = _attention_block(
        L.rms_norm(x, p["attn_norm"], cfg.norm_eps), p["attn"], cfg, sctx, cos, sin,
        cache=cache, impl=impl, lengths=lengths,
    )
    x = x + h
    h = _ffn_block(L.rms_norm(x, p["ffn_norm"], cfg.norm_eps), p, cfg, sctx, impl)
    return x + h, new_cache


def _impl(cfg: ArchConfig) -> str:
    return cfg.quant.impl if cfg.quant.enabled else "dense"


def _head_impl(cfg: ArchConfig) -> str:
    return "dense" if cfg.tie_embeddings else _impl(cfg)


def _embed(params, tokens):
    return _params.embed_lookup(params["embed"], tokens).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, aux)``;
    ``aux`` holds the JAX package's MoE terms, zero for the dense family."""
    _check_ported(cfg)
    if frontend_embeds is not None:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED_MOE_VIT}")
    x = sctx.act_btd(_embed(params, tokens))
    B, S, D = x.shape
    cos, sin = L.rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    impl = _impl(cfg)

    def layer(h, lp):
        return _layer_fwd(h, lp, cfg, sctx, cos, sin, impl=impl)[0]

    def body(h, lp):
        if cfg.remat and torch.is_grad_enabled():
            # jax.checkpoint's counterpart: the layer keeps only its input
            # and reruns (K1 included) in the backward
            return checkpoint(layer, h, lp, use_reentrant=False), None
        return layer(h, lp), None

    x, _ = maybe_scan(body, x, params["layers"], cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.linear(x, _lm_head(params, cfg), _head_impl(cfg))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, {"moe_load_balance": zero, "moe_drop_frac": zero.clone()}


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """One KV cache per layer (``"scan"``), on ``device`` (default the card;
    ``"meta"`` for shapes only).  ``"dense"`` holds the leading dense layers
    of the MoE family, empty here."""
    _check_ported(cfg)
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    if cfg.quant.enabled and cfg.quant.kv_bits == 8:
        one = lambda: A.init_quant_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd,  # noqa: E731
                                            device=dev)
    else:
        one = lambda: A.init_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd, dtype,  # noqa: E731
                                      device=dev)
    return {"dense": [], "scan": [one() for _ in range(cfg.n_layers)]}


def decode_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
                sctx: ShardCtx = ShardCtx()) -> tuple:
    """One autoregressive step against the KV caches.  ``tokens (B, 1)``.
    Returns ``(logits, caches)``; RoPE takes each slot's own position."""
    _check_ported(cfg)
    x = sctx.act_btd(_embed(params, tokens))
    # every layer advances in lockstep: layer 0's counters position all slots
    pos = caches["scan"][0].pos
    cos, sin = L.rope(pos, cfg.hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, hd/2): per-slot rope
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        return _layer_fwd(h, lp, cfg, sctx, cos, sin, cache=cache, impl=impl)

    x, new_scan = maybe_scan(body, x, list(zip(params["layers"], caches["scan"])),
                             cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = L.linear(x, _lm_head(params, cfg), _head_impl(cfg))
    return logits, {"dense": [], "scan": new_scan}


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, lengths: Optional[torch.Tensor] = None,
            frontend_embeds=None) -> tuple:
    """Run the prompt through the model, filling caches.  Returns
    ``(logits, caches)``.

    ``lengths`` (B,) marks each slot's REAL prompt length in a right-padded
    batch: cache counters advance by ``lengths`` (pad rows are never valid
    to decode) and the returned logits are each slot's LAST REAL position.
    ``None`` keeps the full-length semantics (every slot is S tokens).
    """
    _check_ported(cfg)
    if frontend_embeds is not None:
        raise NotImplementedError(f"{cfg.name}: {NOT_PORTED_MOE_VIT}")
    x = sctx.act_btd(_embed(params, tokens))
    B, S, D = x.shape
    cos, sin = L.rope(torch.arange(S, device=x.device), cfg.hd, cfg.rope_theta)
    cos, sin = cos[None], sin[None]
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        return _layer_fwd(h, lp, cfg, sctx, cos, sin, cache=cache, impl=impl,
                          lengths=lengths)

    x, new_scan = maybe_scan(body, x, list(zip(params["layers"], caches["scan"])),
                             cfg.scan_layers)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if lengths is None:
        x_last = x[:, -1:]
    else:
        last = torch.clamp(lengths.long() - 1, 0, S - 1)
        x_last = x[torch.arange(B, device=x.device), last][:, None]
    logits = L.linear(x_last, _lm_head(params, cfg), _head_impl(cfg))
    return logits, {"dense": [], "scan": new_scan}
