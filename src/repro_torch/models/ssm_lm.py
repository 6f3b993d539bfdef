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

An active :class:`~repro_torch.models.common.ShardCtx` runs the tensor
parallelism SPMD, one process a rank, on params placed by
``models/sharding.py::place_params`` and caches by ``place_caches`` (the
transformer's contract: global inputs, the global logits on every rank).
Three layouts disagree, so activations move, never a leaf:

- ``in_proj``'s column block cuts across ``z | xBC | dt``: its output is
  gathered whole (``relayout``);
- the conv, its bias and its window cache hold a contiguous block of the
  ``conv_dim`` channels: each rank convolves its channels, and the conv
  output is gathered whole (``relayout``) — B and C (``n_groups`` 1) are
  read whole, and ``dt`` is whole;
- the SSD state holds every head's block of ``head_dim`` P (``cache_pspecs``):
  the scan runs on the rank's P block of x (each (head, p) channel is its
  own recurrence), and its output is gathered over P (``relayout``);
- the gated RMSNorm takes the whole sum of squares, then the rank's block
  of ``ssm_norm`` scales its contiguous ``d_in`` block, which is
  ``out_proj``'s K block (row-parallel: f32 partials all-reduced).

Per layer the tensors that cross ``model`` are ``in_proj``'s output, the
conv output, the scan output and ``out_proj``'s partial sum; the conv
window, kept whole on the batch, crosses ``data`` (``cache_rows``).
``embed`` is vocab-sharded and ``lm_head`` column-parallel, as in the
transformer.  Mesh (1, 1) runs the unsharded arithmetic.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import (Initializer, ShardCtx, block_of, conv_weight,
                                       embed_tokens, global_logits, local_rows, map_leaves,
                                       maybe_scan, shard_linear, whole_cols, whole_rows)
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
    dev = ini.device
    d_in, H, conv_dim, proj_out = _dims(cfg)
    return {
        "attn_norm": torch.zeros((D,), device=dev),
        "in_proj": ini.dense((D, proj_out)),
        "conv_w": ini.normal((s.d_conv, conv_dim)) * 0.1,
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "ssm_D": torch.ones((H,), device=dev),
        "dt_bias": torch.full((H,), math.log(math.expm1(0.01)), device=dev),  # softplus⁻¹
        "ssm_norm": torch.zeros((d_in,), device=dev),
        "out_proj": ini.dense((d_in, D), fan_in=d_in),
    }


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype=torch.float32, *, device=None) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws).  ``device="meta"``: the shapes and dtypes only, no
    generator needed."""
    ini = Initializer(gen, device)
    dev = ini.device
    params = {
        "embed": ini.normal((cfg.vocab, cfg.d_model)) * 0.02,
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


def _p_block(cfg: ArchConfig, sctx: ShardCtx) -> slice:
    """The block of ``head_dim`` P this rank's SSD state holds: P over
    ``model`` where it divides (``cache_pspecs``), else all of it."""
    P = cfg.ssm.head_dim
    if sctx.active and sctx.tp > 1 and P % sctx.tp == 0:
        return block_of(P, P // sctx.tp, sctx)
    return slice(0, P)


def _distinct(t, sctx: ShardCtx):
    """``t``, replicated over ``model``, entering rank-distinct work (a
    block of its channels, the scan on a P block): its gradient is summed
    over ``model`` in the backward (``launch/mesh.py::enter_split``)."""
    if not sctx.active:
        return t
    from repro_torch.launch.mesh import enter_split

    return enter_split(t, sctx.mesh, sctx.model)


def _mixer_in(xn, p, cfg: ArchConfig, sctx: ShardCtx, impl: str) -> tuple:
    """``in_proj`` whole: ``(z, this rank's conv channels of xBC, dt)``."""
    _, _, conv_dim, proj_out = _dims(cfg)
    z, xbc_in, dt = _split_proj(
        whole_cols(shard_linear(xn, p["in_proj"], impl, sctx), proj_out, sctx), cfg)
    ch = block_of(conv_dim, conv_weight(p).shape[-1], sctx)
    if ch != slice(0, conv_dim):
        xbc_in = _distinct(xbc_in, sctx)
    return z, xbc_in[..., ch], dt


def _ssm_args(xbc_blk, dt, p, cfg: ArchConfig, sctx: ShardCtx) -> tuple:
    """The conv output (this rank's channels, activated) gathered whole →
    the scan's ``(x, dt, A, B, C, D)``, x on this rank's P block (every
    input then enters rank-distinct work)."""
    xbc = whole_cols(F.silu(xbc_blk), _dims(cfg)[2], sctx)
    pb = _p_block(cfg, sctx)
    split = pb != slice(0, cfg.ssm.head_dim)
    if split:
        xbc = _distinct(xbc, sctx)
    xs, Bm, Cm, dt, A = _ssm_inputs(xbc, dt, p, cfg)
    D = p["ssm_D"].float()
    if split:
        dt, A, D = (_distinct(t, sctx) for t in (dt, A, D))
    return xs[..., pb], dt, A, Bm, Cm, D


def _gated_norm(g, scale, cfg: ArchConfig, sctx: ShardCtx):
    """The gated RMSNorm over the whole ``d_in``, this rank's block of it
    scaled by its block of ``ssm_norm`` (``out_proj``'s K block)."""
    d_in = g.shape[-1]
    cols = block_of(d_in, scale.shape[-1], sctx)
    if cols == slice(0, d_in):
        return L.rms_norm(g, scale, cfg.norm_eps)
    x = g.float()
    x = _distinct(x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + cfg.norm_eps),
                  sctx)[..., cols]
    return (x * (1.0 + scale.float())).to(g.dtype)


def _mixer_out(y_blk, z, p, cfg: ArchConfig, sctx: ShardCtx, impl: str):
    """The scan's output (this rank's P block) gathered over P, gated,
    normed and through ``out_proj``."""
    y = whole_cols(y_blk, cfg.ssm.head_dim, sctx)
    y = _gated_norm(y.reshape(*y.shape[:-2], -1) * F.silu(z), p["ssm_norm"], cfg, sctx)
    return shard_linear(sctx.act_btf(y), p["out_proj"], impl, sctx)


def _layer_fwd(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str) -> tuple:
    """Full-sequence SSD layer.  Returns (y, final_ssm_state, last_conv_win)."""
    s = cfg.ssm
    xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    z, xbc_in, dt = _mixer_in(xn, p, cfg, sctx, impl)
    args = _ssm_args(RG.causal_conv1d(xbc_in, conv_weight(p), p["conv_b"]), dt, p, cfg, sctx)
    y, h_final = S.ssd_scan(*args, chunk=min(s.chunk, x.shape[1]))
    out = _mixer_out(y, z, p, cfg, sctx, impl)
    return sctx.act_btd(out), h_final, RG.conv_window(xbc_in, s.d_conv)


def _impl(cfg: ArchConfig) -> str:
    return cfg.quant.impl if cfg.quant.enabled else "dense"


# the activations' dtype, bf16 as in the JAX package
_ACT = torch.bfloat16


def _embed(params, tokens, sctx: ShardCtx):
    """This rank's rows of ``tokens``, embedded."""
    return sctx.act_btd(embed_tokens(params["embed"], local_rows(tokens, sctx), sctx).to(_ACT))


def _head(params, x, cfg: ArchConfig, impl: str, sctx: ShardCtx, block: bool = False):
    """The global logits of this rank's rows ``x`` (with ``block`` this
    rank's block of them)."""
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return global_logits(shard_linear(x, params["lm_head"], impl, sctx), cfg, sctx,
                         block=block)


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None,
            logits_block: bool = False) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, {})``:
    global on every rank, or with ``logits_block`` this rank's block.
    With ``cfg.remat`` a differentiated call recomputes each layer in the
    backward."""
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
    return _head(params, x, cfg, impl, sctx, logits_block), {}


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """SSM state + conv window per layer (no KV cache: attention-free), on
    ``device`` (default the card; ``"meta"`` for shapes only).  Under a
    mesh ``place_caches`` holds the state's batch rows and P block, the
    window's channel block (whole on the batch), ``pos`` replicated."""
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
    x = _embed(params, tokens, sctx)[:, 0]  # (B, D)
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        xn = L.rms_norm(h, lp["attn_norm"], cfg.norm_eps)
        z, xbc, dt = _mixer_in(xn, lp, cfg, sctx, impl)
        xbc, new_win = RG.conv1d_decode_step(xbc, conv_weight(lp), lp["conv_b"],
                                             local_rows(cache["conv"], sctx))
        y, new_state = S.ssd_decode_step(*_ssm_args(xbc, dt, lp, cfg, sctx), cache["ssm"])
        out = _mixer_out(y, z, lp, cfg, sctx, impl)
        return h + out, {"ssm": new_state, "conv": whole_rows(new_win, sctx),
                         "pos": cache["pos"] + 1}

    x, new = maybe_scan(body, x, list(zip(params["layers"], caches["layers"])),
                        cfg.scan_layers)
    return _head(params, x, cfg, impl, sctx)[:, None, :], {"layers": new}


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), **kw) -> tuple:
    """Prompt pass producing final states (the chunked SSD scan).  Returns
    ``(logits of the last position (B, 1, V), caches)``.

    Right-padded prompts (``lengths=``) are NOT supported: the SSD scan
    folds every input token into the recurrent state, so pad tokens would
    corrupt it.  Serve SSM slots with exact-length prompts (bucket
    granularity 1).
    """
    if kw.get("lengths") is not None:
        raise ValueError("ssm_lm.prefill: padded prompts (lengths=) unsupported — "
                         "the recurrent scan would absorb pad tokens into state")
    x = _embed(params, tokens, sctx)
    impl = _impl(cfg)

    def body(h, inp):
        lp, cache = inp
        y, h_final, last_win = _layer_fwd(h, lp, cfg, sctx, impl)
        return h + y, {"ssm": h_final,
                       "conv": whole_rows(last_win.to(cache["conv"].dtype), sctx),
                       "pos": cache["pos"] + tokens.shape[1]}

    x, new = maybe_scan(body, x, list(zip(params["layers"], caches["layers"])),
                        cfg.scan_layers)
    return _head(params, x[:, -1:], cfg, impl, sctx), {"layers": new}
