"""Mamba-2 language model (SSD blocks, attention-free): mamba2-130m.

Port of ``repro.models.ssm_lm``.  Per-layer parameters and caches are
lists of per-layer dicts walked by :func:`maybe_scan`.  ``in_proj``,
``out_proj`` and the head go through :func:`repro_torch.nn.layers.linear`
(K1 on the card under ``kernel``); the conv and the SSD scan stay plain.
The conv window carried into decode is left-padded with zeros, so a
prompt shorter than ``d_conv − 1`` tokens decodes (the JAX package's
``prefill`` cannot take one).  Prefill refuses right-padded prompts: the
scan would fold the pads into the state, so the engine serves this family
at the exact prompt length.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core import params as _params
from repro_torch.models.common import (Initializer, ShardCtx, map_leaves, maybe_scan,
                                       refuse_mesh)
from repro_torch.nn import layers as L
from repro_torch.nn import rglru as RG  # causal_conv1d shared
from repro_torch.nn import ssm as S

__all__ = ["init_params", "forward", "init_caches", "prefill", "decode_step"]


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + H
    return d_in, H, conv_dim, proj_out


def _init_layer(cfg: ArchConfig, ini: Initializer) -> dict:
    s = cfg.ssm
    D = cfg.d_model
    dev = ini.gen.device
    d_in, H, conv_dim, proj_out = _dims(cfg)
    return {
        "attn_norm": torch.zeros((D,), device=dev),
        "in_proj": ini.dense((D, proj_out)),
        "conv_w": torch.randn((s.d_conv, conv_dim), generator=ini.gen, device=dev) * 0.1,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "ssm_D": torch.ones((H,), device=dev),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), device=dev),  # softplus⁻¹
        "ssm_norm": torch.zeros((d_in,), device=dev),
        "out_proj": ini.dense((d_in, D), fan_in=d_in),
    }


def init_params(cfg: ArchConfig, gen: torch.Generator, dtype=torch.float32) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws)."""
    ini = Initializer(gen)
    dev = gen.device
    params = {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen, device=dev) * 0.02,
        "layers": [_init_layer(cfg, ini) for _ in range(cfg.n_layers)],
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
        "lm_head": ini.dense((cfg.d_model, cfg.vocab)),
    }
    if dtype != torch.float32:
        params = map_leaves(lambda _, x: x.to(dtype), params)
    return params


def _split_proj(proj, cfg: ArchConfig) -> tuple:
    d_in, _, conv_dim, _ = _dims(cfg)
    return proj[..., :d_in], proj[..., d_in:d_in + conv_dim], proj[..., d_in + conv_dim:]


def _ssm_inputs(xbc, dt, p, cfg: ArchConfig) -> tuple:
    """Split the conv output into x, B, C (heads and groups on their own
    axes) and make ``dt`` and ``A``."""
    s = cfg.ssm
    d_in, H, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    lead = xbc.shape[:-1]
    xs = xbc[..., :d_in].reshape(*lead, H, s.head_dim)
    Bm = xbc[..., d_in:d_in + gn].reshape(*lead, s.n_groups, s.d_state)
    Cm = xbc[..., d_in + gn:].reshape(*lead, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"].float())
    return xs, Bm, Cm, dt, A


def _layer_fwd(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str) -> tuple:
    """Full-sequence SSD layer.  Returns (y, final_ssm_state, last_conv_win)."""
    s = cfg.ssm
    Bsz, Sq, _ = x.shape
    d_in = _dims(cfg)[0]
    xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    z, xbc_in, dt = _split_proj(L.linear(xn, p["in_proj"], impl), cfg)
    xbc = F.silu(RG.causal_conv1d(xbc_in, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm, dt, A = _ssm_inputs(xbc, dt, p, cfg)
    y, h_final = S.ssd_scan(xs, dt, A, Bm, Cm, p["ssm_D"].float(),
                            chunk=min(s.chunk, Sq))
    y = L.rms_norm(y.reshape(Bsz, Sq, d_in) * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    out = L.linear(sctx.act_btf(y), p["out_proj"], impl)
    return sctx.act_btd(out), h_final, RG.conv_window(xbc_in, s.d_conv)


def _impl(cfg: ArchConfig) -> str:
    return cfg.quant.impl if cfg.quant.enabled else "dense"


# the activations' dtype, bf16 as in the JAX package
_ACT = torch.bfloat16


def _embed(params, tokens, sctx: ShardCtx):
    return sctx.act_btd(_params.embed_lookup(params["embed"], tokens).to(_ACT))


def _head(params, x, cfg: ArchConfig, impl: str):
    return L.linear(L.rms_norm(x, params["final_norm"], cfg.norm_eps), params["lm_head"], impl)


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, {})``.
    With ``cfg.remat`` a differentiated call recomputes each layer in the
    backward."""
    refuse_mesh(sctx)
    del frontend_embeds
    x = _embed(params, tokens, sctx)
    impl = _impl(cfg)

    def layer(h, lp):
        return h + _layer_fwd(h, lp, cfg, sctx, impl)[0]

    def body(h, lp):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer, h, lp, use_reentrant=False), None
        return layer(h, lp), None

    x, _ = maybe_scan(body, x, params["layers"], cfg.scan_layers)
    return _head(params, x, cfg, impl), {}


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """SSM state + conv window per layer (no KV cache: attention-free), on
    ``device`` (default the card; ``"meta"`` for shapes only)."""
    del seq
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    s = cfg.ssm
    _, H, conv_dim, _ = _dims(cfg)

    def one():
        return {
            "ssm": torch.zeros((batch, H, s.head_dim, s.d_state), dtype=torch.float32,
                               device=dev),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype, device=dev),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),  # per slot
        }

    return {"layers": [one() for _ in range(cfg.n_layers)]}


def decode_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
                sctx: ShardCtx = ShardCtx()) -> tuple:
    """One autoregressive step.  ``tokens (B, 1)``; returns ``(logits (B, 1,
    V), caches)``."""
    refuse_mesh(sctx)
    d_in = _dims(cfg)[0]
    x = _embed(params, tokens, sctx)[:, 0]  # (B, D)
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        xn = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        z, xbc, dt = _split_proj(L.linear(xn, lp["in_proj"], impl), cfg)
        xbc, new_win = RG.conv1d_decode_step(xbc, lp["conv_w"], lp["conv_b"], cache["conv"])
        xs, Bm, Cm, dt, A = _ssm_inputs(F.silu(xbc), dt, lp, cfg)
        y, new_state = S.ssd_decode_step(xs, dt, A, Bm, Cm, lp["ssm_D"].float(),
                                         cache["ssm"])
        y = L.rms_norm(y.reshape(-1, d_in) * F.silu(z), lp["ssm_norm"], cfg.norm_eps)
        out = L.linear(y, lp["out_proj"], impl)
        return h + out, {"ssm": new_state, "conv": new_win, "pos": cache["pos"] + 1}

    x, new = maybe_scan(body, x, list(zip(params["layers"], caches["layers"])),
                        cfg.scan_layers)
    return _head(params, x, cfg, impl)[:, None, :], {"layers": new}


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), **kw) -> tuple:
    """Prompt pass producing final states (the chunked SSD scan).  Returns
    ``(logits of the last position (B, 1, V), caches)``.

    Right-padded prompts (``lengths=``) are NOT supported: the SSD scan
    folds every input token into the recurrent state, so pad tokens would
    corrupt it.  Serve SSM slots with exact-length prompts (bucket
    granularity 1).
    """
    refuse_mesh(sctx)
    if kw.get("lengths") is not None:
        raise ValueError("ssm_lm.prefill: padded prompts (lengths=) unsupported — "
                         "the recurrent scan would absorb pad tokens into state")
    x = _embed(params, tokens, sctx)
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        y, h_final, last_win = _layer_fwd(h, lp, cfg, sctx, impl)
        return h + y, {"ssm": h_final, "conv": last_win.to(cache["conv"].dtype),
                       "pos": cache["pos"] + tokens.shape[1]}

    x, new = maybe_scan(body, x, list(zip(params["layers"], caches["layers"])),
                        cfg.scan_layers)
    return _head(params, x[:, -1:], cfg, impl), {"layers": new}
