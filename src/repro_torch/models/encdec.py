"""Whisper-style encoder–decoder (whisper-tiny backbone).

Port of ``repro.models.encdec``.  The conv/mel frontend is real: log-mel
frames ``(B, n_mels, T_mel)`` run through the two Whisper stem convs
(kernel 3 along time; the second at stride 2) via
:func:`repro_torch.core.conv.conv2d` — the same engines the CNN stack uses
(K1 over im2col on ``kernel``, K3 on ``pas_kernel``), which is how the
paper's technique is proven on voice.  :func:`quantize_frontend`
weight-shares the stem kernels into
:class:`~repro_torch.core.conv.ConvParams` dictionaries
(``quantize_params`` keeps conv leaves dense by name, so the frontend opts
in explicitly).

The encoder is non-causal self-attention; the decoder is causal
self-attention + cross-attention onto the fixed-length encoder output.
LayerNorm-with-bias and tanh GELU match the Whisper family; token
embeddings are tied to the LM head.  ``"enc_layers"`` and ``"dec_layers"``
are lists of per-layer dicts, and the caches a list of per-layer
``{"self": KVCache, "cross": {"k", "v"}}``; the cross K/V are computed once
at prefill and read by every decode step.

An active :class:`~repro_torch.models.common.ShardCtx` runs the tensor
parallelism SPMD, one process a rank, on params placed by
``models/sharding.py::place_params`` and caches by ``place_caches`` (the
transformer's contract: global inputs, the global logits — and from
:func:`encode` the global encoding — on every rank).  The encoder, the
decoder's self- and cross-attention and the MLPs are Megatron blocks:
``wq/wk/wv``/``w1`` column-parallel (``bias1`` narrowed to the rank's
block), ``wo``/``w2`` row-parallel; whisper-tiny's 6 heads split 3 + 3 at
``model`` 2 and the self and cross K/V caches hold the rank's heads (KV
heads that do not divide ``model`` are gathered whole, attention runs on
the rank's block of q heads and the caches' positions split instead, as
in the transformer).  The mel stem's conv leaves match no
placement rule, so the stem runs whole on every rank; ``embed`` is
vocab-sharded where the vocab divides (51865 does not: it is held whole,
with the tied head on it), and ``pos_embed``'s rows split the same way.
Mesh (1, 1) runs the unsharded arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core.conv import Conv2D, ConvParams, conv2d
from repro_torch.models.common import (Initializer, ShardCtx, block_of, embed_tokens,
                                       global_logits, head_block, kv_heads_split, local_rows,
                                       map_leaves, maybe_scan, proj_heads, qkv_heads,
                                       shard_linear, tied_head, whole_rows)
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L

__all__ = [
    "init_params",
    "forward",
    "encode",
    "init_caches",
    "prefill",
    "decode_step",
    "quantize_frontend",
]

# the activations' dtype, bf16 as in the JAX package
_ACT = torch.bfloat16


def _sinusoid(length: int, channels: int, device=None) -> torch.Tensor:
    """The encoder's sinusoidal positions ``(length, channels)``, f32."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(channels // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-dim * math.log(10_000.0) / (channels // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_attn(cfg: ArchConfig, ini: Initializer) -> dict:
    D, hd = cfg.d_model, cfg.hd
    return {
        "wq": ini.dense((D, cfg.n_heads * hd)),
        "wk": ini.dense((D, cfg.n_kv_heads * hd)),
        "wv": ini.dense((D, cfg.n_kv_heads * hd)),
        "wo": ini.dense((cfg.n_heads * hd, D)),
    }


def _init_mlp(cfg: ArchConfig, ini: Initializer) -> dict:
    dev = ini.device
    return {
        "w1": ini.dense((cfg.d_model, cfg.d_ff)),
        "bias1": torch.zeros((cfg.d_ff,), device=dev),
        "w2": ini.dense((cfg.d_ff, cfg.d_model), fan_in=cfg.d_ff),
        "bias2": torch.zeros((cfg.d_model,), device=dev),
    }


def _ln(d: int, dev) -> dict:
    return {"scale": torch.ones((d,), device=dev), "bias": torch.zeros((d,), device=dev)}


def _init_enc_layer(cfg: ArchConfig, ini: Initializer) -> dict:
    dev = ini.device
    return {"ln1": _ln(cfg.d_model, dev), "attn": _init_attn(cfg, ini),
            "ln2": _ln(cfg.d_model, dev), "mlp": _init_mlp(cfg, ini)}


def _init_dec_layer(cfg: ArchConfig, ini: Initializer) -> dict:
    dev = ini.device
    return {"ln1": _ln(cfg.d_model, dev), "attn": _init_attn(cfg, ini),
            "ln_cross": _ln(cfg.d_model, dev), "cross": _init_attn(cfg, ini),
            "ln2": _ln(cfg.d_model, dev), "mlp": _init_mlp(cfg, ini)}


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype=torch.float32, *, device=None) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws).  Use a CUDA generator for the card.  ``device="meta"``: the
    shapes and dtypes only, no generator needed."""
    ini = Initializer(gen, device)
    D, dev = cfg.d_model, ini.device
    params = {
        "embed": ini.normal((cfg.vocab, D)) * 0.02,
        "pos_embed": ini.normal((cfg.max_seq, D)) * 0.01,
        # Whisper stem: two kernel-3 time convs, the second at stride 2.
        # The "conv" in the names keeps quantize_params' _EXCLUDE away:
        # weight-sharing the stem is an explicit quantize_frontend() opt-in
        "frontend": {
            "conv1": {"kernel": ini.dense((D, cfg.n_mels, 1, 3), fan_in=cfg.n_mels * 3),
                      "bias": torch.zeros((D,), device=dev)},
            "conv2": {"kernel": ini.dense((D, D, 1, 3), fan_in=D * 3),
                      "bias": torch.zeros((D,), device=dev)},
        },
        "enc_layers": [_init_enc_layer(cfg, ini) for _ in range(cfg.encoder_layers)],
        "enc_ln": _ln(D, dev),
        "dec_layers": [_init_dec_layer(cfg, ini) for _ in range(cfg.n_layers)],
        "dec_ln": _ln(D, dev),
    }
    if dtype != torch.float32:
        params = map_leaves(lambda _, x: x.to(dtype), params)
    return params


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def _impl(cfg: ArchConfig) -> str:
    return cfg.quant.impl if cfg.quant.enabled else "dense"


def _mha(xq, xkv, p, cfg: ArchConfig, impl: str, sctx: ShardCtx, *, causal: bool):
    hb = head_block(cfg, sctx)
    q, k, v = qkv_heads(xq, xkv, p, cfg, sctx, impl, hb)
    o = A.gqa_attention(q, *hb.kv(k, v), causal=causal, chunk=min(1024, k.shape[1]))
    return shard_linear(hb.out(o), p["wo"], impl, sctx)


def _mlp_fwd(x, p, impl: str, sctx: ShardCtx):
    h = shard_linear(x, p["w1"], impl, sctx)
    b1 = p["bias1"][block_of(p["bias1"].shape[-1], h.shape[-1], sctx)]
    h = L.gelu_ffn_act(h + b1.to(x.dtype))
    return shard_linear(h, p["w2"], impl, sctx) + p["bias2"].to(x.dtype)


def _lnorm(x, p, eps: float = 1e-5):
    return L.layer_norm(x, p["scale"], p["bias"], eps)


def _stem_convs(cfg: ArchConfig) -> tuple:
    """The two Whisper stem conv specs (kernel 3 on time; second at stride 2)."""
    return (
        Conv2D(k=(1, 3), c_in=cfg.n_mels, c_out=cfg.d_model, stride=1, padding="same"),
        Conv2D(k=(1, 3), c_in=cfg.d_model, c_out=cfg.d_model, stride=2, padding="same"),
    )


# the stem's impl → conv engine map (the JAX package's): dequant → the
# einsum reference, kernel → K1 over im2col, pas_kernel → K3; anything else
# lets conv2d choose
_STEM_ENGINE = {"dequant": "einsum", "kernel": "kernel", "pas_kernel": "pas_kernel"}


def _frontend_conv(x, p, conv: Conv2D, impl: str) -> torch.Tensor:
    """One stem conv through :func:`conv2d`.  ``p`` is the init dict
    (``kernel``/``bias``: dense, always ``einsum``) or a ``ConvParams``
    installed by :func:`quantize_frontend`, routed by ``impl``."""
    if isinstance(p, dict):
        return conv2d(x, ConvParams.dense(p["kernel"], bias=p["bias"]), conv,
                      engine="einsum")
    return conv2d(x, p, conv, engine=_STEM_ENGINE.get(impl, "auto"))


def quantize_frontend(params: dict, bins: int = 16, *, iters: int = 16) -> dict:
    """Weight-share the mel-stem convs into ``ConvParams`` dictionaries, one
    per stem conv (paper §4); k-means runs on the kernels' device."""
    fe = {name: ConvParams.quantize(p["kernel"], bins, bias=p["bias"], iters=iters)
          for name, p in params["frontend"].items()}
    return {**params, "frontend": fe}


def _remat(fn, cfg: ArchConfig, *args):
    """``fn(*args)``; with ``cfg.remat`` a differentiated call keeps only the
    inputs and reruns ``fn`` in the backward (``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def encode(params: dict, mel: torch.Tensor, cfg: ArchConfig,
           sctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """mel ``(B, n_mels, T_mel)`` log-mel frames → ``(B, T_mel // 2,
    d_model)``.  The stem runs in f32 (on ``kernel``, K1's f32 route); the
    sinusoid is added before the cast to the activations' dtype.  Under an
    active context every rank passes the global mel and gets the global
    encoding."""
    return whole_rows(_encode(params, local_rows(mel, sctx), cfg, sctx), sctx,
                      key="all_gather")


def _encode(params: dict, mel: torch.Tensor, cfg: ArchConfig, sctx: ShardCtx) -> torch.Tensor:
    """:func:`encode` of this rank's rows."""
    impl = _impl(cfg)
    c1, c2 = _stem_convs(cfg)
    fe = params["frontend"]
    x4 = mel.to(torch.float32)[:, :, None, :]  # NCHW: (B, n_mels, 1, T_mel)
    x4 = L.gelu_ffn_act(_frontend_conv(x4, fe["conv1"], c1, impl))
    x4 = L.gelu_ffn_act(_frontend_conv(x4, fe["conv2"], c2, impl))
    x = x4[:, :, 0, :].transpose(1, 2)  # (B, T_mel // 2, d_model)
    x = (x + _sinusoid(x.shape[1], cfg.d_model, x.device)).to(_ACT)
    x = sctx.act_btd(x)

    def layer(h, lp):
        xn = _lnorm(h, lp["ln1"])
        h = h + _mha(xn, xn, lp["attn"], cfg, impl, sctx, causal=False)
        return h + _mlp_fwd(_lnorm(h, lp["ln2"]), lp["mlp"], impl, sctx)

    x, _ = maybe_scan(lambda h, lp: (_remat(layer, cfg, h, lp), None), x,
                      params["enc_layers"], cfg.scan_layers)
    return _lnorm(x, params["enc_ln"])


def _silence(cfg: ArchConfig, batch: int, device) -> torch.Tensor:
    return torch.zeros((batch, cfg.n_mels, 2 * cfg.frontend_tokens), dtype=_ACT,
                       device=device)


def _embed(params: dict, tokens: torch.Tensor, pos: torch.Tensor,
           sctx: ShardCtx) -> torch.Tensor:
    """Token embeddings plus the learned positions ``pos`` (``(S,)`` shared
    or ``(B, 1)`` per slot), in the activations' dtype.  Both tables are
    row-sharded over ``model`` where their rows divide it (``param_pspecs``'
    ``embed`` rule also takes ``pos_embed``)."""
    x = embed_tokens(params["embed"], tokens, sctx).to(_ACT)
    return x + embed_tokens(params["pos_embed"], pos.long(), sctx).to(_ACT)


def _head(params: dict, x: torch.Tensor, cfg: ArchConfig, sctx: ShardCtx,
          block: bool = False) -> torch.Tensor:
    """The tied head: ``x @ embedᵀ``, a dense product outside any kernel;
    the global logits of this rank's rows (with ``block`` this rank's
    block of them)."""
    x = _lnorm(x, params["dec_ln"])
    return global_logits(shard_linear(x, tied_head(params["embed"], cfg, sctx), "dense", sctx),
                         cfg, sctx, block=block)


def _self_local(cache, sctx: ShardCtx):
    """A self-KV cache with this rank's rows' counters (``pos`` is whole)."""
    return dataclasses.replace(cache, pos=local_rows(cache.pos, sctx))


def _mesh(sctx: ShardCtx):
    return sctx.mesh if sctx.active else None


def _cross_shards(cfg: ArchConfig, sctx: ShardCtx) -> int:
    """Ranks the cross K/V's positions split over: ``cache_pspecs`` puts
    them on ``model`` when the KV heads do not divide it and they do."""
    if not sctx.active or sctx.tp == 1 or kv_heads_split(cfg, sctx) \
            or cfg.frontend_tokens % sctx.tp:
        return 1
    return sctx.tp


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *,
            frontend_embeds: Optional[torch.Tensor] = None,
            logits_block: bool = False) -> tuple:
    """Teacher-forced decode over ``tokens`` given log-mel
    ``frontend_embeds`` (silence when None).  Returns ``(logits, {})``:
    global on every rank, or with ``logits_block`` this rank's block."""
    impl = _impl(cfg)
    B, S = tokens.shape
    if frontend_embeds is None:
        frontend_embeds = _silence(cfg, B, tokens.device)
    enc = _encode(params, local_rows(frontend_embeds, sctx), cfg, sctx)
    x = sctx.act_btd(_embed(params, local_rows(tokens, sctx),
                            torch.arange(S, device=tokens.device), sctx))

    def layer(h, lp):
        xn = _lnorm(h, lp["ln1"])
        h = h + _mha(xn, xn, lp["attn"], cfg, impl, sctx, causal=True)
        h = h + _mha(_lnorm(h, lp["ln_cross"]), enc, lp["cross"], cfg, impl, sctx,
                     causal=False)
        return h + _mlp_fwd(_lnorm(h, lp["ln2"]), lp["mlp"], impl, sctx)

    x, _ = maybe_scan(lambda h, lp: (_remat(layer, cfg, h, lp), None), x,
                      params["dec_layers"], cfg.scan_layers)
    return _head(params, x, cfg, sctx, logits_block), {}


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> list:
    """Per decoder layer ``{"self": KVCache, "cross": {"k", "v"}}``, the
    cross K/V ``(B, frontend_tokens, KV, hd)``, on ``device`` (default the
    card; ``"meta"`` for shapes only)."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    cross = (batch, cfg.frontend_tokens, cfg.n_kv_heads, cfg.hd)

    def one():
        return {"self": A.init_kv_cache(batch, seq, cfg.n_kv_heads, cfg.hd, dtype,
                                        device=dev),
                "cross": {"k": torch.zeros(cross, dtype=dtype, device=dev),
                          "v": torch.zeros(cross, dtype=dtype, device=dev)}}

    return [one() for _ in range(cfg.n_layers)]


def prefill(params: dict, tokens: torch.Tensor, caches: list, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, lengths: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None) -> tuple:
    """Encode the audio (silence when None), compute each layer's cross
    K/V once, and run the prompt through the decoder.  Returns ``(logits,
    caches)``.

    ``lengths`` (B,) marks each slot's real prompt length in a right-padded
    batch (the transformer's contract): the self-KV counters advance by it
    and the logits are each slot's last real position.
    """
    impl = _impl(cfg)
    B, S = tokens.shape
    mesh = _mesh(sctx)
    if frontend_embeds is None:
        frontend_embeds = _silence(cfg, B, tokens.device)
    enc = _encode(params, local_rows(frontend_embeds, sctx), cfg, sctx)
    x = _embed(params, local_rows(tokens, sctx), torch.arange(S, device=tokens.device),
               sctx)
    mine = local_rows(lengths, sctx)
    adv = S if lengths is None else lengths.to(torch.int32)
    hb = head_block(cfg, sctx)

    def body(h, inp):
        lp, cache = inp
        xn = _lnorm(h, lp["ln1"])
        q, k, v = qkv_heads(xn, xn, lp["attn"], cfg, sctx, impl, hb)
        o = A.gqa_attention(q, *hb.kv(k, v), causal=True, chunk=min(1024, S))
        h = h + shard_linear(hb.out(o), lp["attn"]["wo"], impl, sctx)
        new_self = A.update_cache(_self_local(cache["self"], sctx), k, v, lengths=mine,
                                  mesh=mesh)
        new_self = dataclasses.replace(new_self, pos=cache["self"].pos + adv)
        qc, ck, cv = qkv_heads(_lnorm(h, lp["ln_cross"]), enc, lp["cross"], cfg, sctx, impl,
                               hb)
        oc = A.gqa_attention(qc, *hb.kv(ck, cv), causal=False, chunk=min(1024, ck.shape[1]))
        h = h + shard_linear(hb.out(oc), lp["cross"]["wo"], impl, sctx)
        h = h + _mlp_fwd(_lnorm(h, lp["ln2"]), lp["mlp"], impl, sctx)
        cross = cache["cross"]
        # the cross K/V's positions this rank holds (all, unless they split)
        at = block_of(ck.shape[1], ck.shape[1] // _cross_shards(cfg, sctx), sctx)
        return h, {"self": new_self, "cross": {"k": ck[:, at].to(cross["k"].dtype),
                                               "v": cv[:, at].to(cross["v"].dtype)}}

    x, new_caches = maybe_scan(body, x, list(zip(params["dec_layers"], caches)),
                               cfg.scan_layers)
    if mine is None:
        x_last = x[:, -1:]
    else:  # each slot's last real position in a right-padded batch
        last = torch.clamp(mine.long() - 1, 0, S - 1)
        x_last = x[torch.arange(x.shape[0], device=x.device), last][:, None]
    return _head(params, x_last, cfg, sctx), new_caches


def decode_step(params: dict, tokens: torch.Tensor, caches: list, cfg: ArchConfig,
                sctx: ShardCtx = ShardCtx()) -> tuple:
    """One autoregressive step: ``tokens (B, 1)`` against each layer's
    self-KV cache and its cross K/V (all ``frontend_tokens`` positions
    valid).  The learned position is each slot's own, clipped to
    ``max_seq − 1``.  Returns ``(logits, caches)``."""
    impl = _impl(cfg)
    mesh = _mesh(sctx)
    pos = caches[0]["self"].pos  # (B,) per-slot positions (every layer in lockstep)
    x = _embed(params, local_rows(tokens, sctx),
               torch.clamp(local_rows(pos, sctx), 0, cfg.max_seq - 1)[:, None], sctx)
    B = x.shape[0]
    hb = head_block(cfg, sctx, decode=True)

    def body(h, inp):
        lp, cache = inp
        xn = _lnorm(h, lp["ln1"])
        q, k, v = qkv_heads(xn, xn, lp["attn"], cfg, sctx, impl, hb)
        new_self = A.update_cache(_self_local(cache["self"], sctx), k, v, mesh=mesh)
        o = A.decode_attention(q, new_self, mesh=mesh)
        h = h + shard_linear(hb.out(o), lp["attn"]["wo"], impl, sctx)
        xn = _lnorm(h, lp["ln_cross"])
        qc = proj_heads(xn, lp["cross"]["wq"], cfg.n_heads, cfg, sctx, impl, hb, query=True)
        ck, shards = cache["cross"]["k"], _cross_shards(cfg, sctx)
        crossc = A.KVCache(k=ck, v=cache["cross"]["v"],  # every encoder position valid
                           pos=torch.full((B,), ck.shape[1] * shards, dtype=torch.int32,
                                          device=ck.device), seq_shards=shards)
        oc = A.decode_attention(qc, crossc, mesh=mesh)
        h = h + shard_linear(hb.out(oc), lp["cross"]["wo"], impl, sctx)
        h = h + _mlp_fwd(_lnorm(h, lp["ln2"]), lp["mlp"], impl, sctx)
        new_self = dataclasses.replace(new_self, pos=cache["self"].pos + 1)
        return h, {"self": new_self, "cross": cache["cross"]}

    x, new_caches = maybe_scan(body, x, list(zip(params["dec_layers"], caches)),
                               cfg.scan_layers)
    return _head(params, x, cfg, sctx), new_caches
