"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks + local attention.

Port of ``repro.models.hybrid``.  Layer pattern (recurrent, recurrent,
attention) tiled over depth (recurrentgemma-2b: 26 layers = 8 groups of 3
+ a 2-layer recurrent tail).  ``"groups"`` is a list of per-group dicts
``{"l0", "l1", "l2"}`` and ``"tail"`` a list of recurrent layers, in the
parameters and in the caches.  Local attention decodes against a ring
buffer of ``min(local_window, seq)`` slots, each slot recording the
absolute position it holds (``slot_pos``, −1 when empty), so decode holds
O(window) state.  Every quantized linear goes through
:func:`repro_torch.nn.layers.linear` (K1 on the card under ``kernel``)
except the RG-LRU gates, which dequantize (:mod:`repro_torch.nn.rglru`).
The conv window carried into decode is left-padded with zeros, so a
prompt shorter than ``conv_width − 1`` tokens decodes (the JAX package's
``prefill`` cannot take one).  Prefill refuses right-padded prompts: the
engine serves this family at the exact prompt length.

An active :class:`~repro_torch.models.common.ShardCtx` runs the tensor
parallelism SPMD, one process a rank, on params placed by
``models/sharding.py::place_params`` and caches by ``place_caches`` (the
transformer's contract: global inputs, the global logits on every rank).
A recurrent layer's ``rec_in`` column block splits ``lru_in | gate`` (at
``model`` 2 rank 0 holds all of ``lru_in``), so its output is gathered
whole (``relayout``) and each rank takes its block of the channels: the
conv, its window, the RG-LRU state, ``lam/b_a/b_x`` and ``rec_out``'s K
block all hold that block; the gates read the whole conv output
(gathered, ``relayout``) through their column blocks (``nn/rglru.py``).
recurrentgemma-2b's one KV head does not divide ``model``: k and v are
gathered whole (a column block of ``wk`` holds half the head's dims) and
the prefill attention runs on the rank's block of the q heads
(``models/common.py::head_block``: 10 heads over ``model`` 2, 5 a rank);
the ring's slots split over ``model`` (``cache_pspecs``: slot ``s`` on
rank ``s // (win / tp)``), so decode runs every head and combines each
rank's softmax partial over its slots in rank order
(:func:`repro_torch.nn.attention.combine_over`), and ``wo`` takes the
rank's K block.  ``slot_pos``, ``pos`` and the recurrent states are whole
on the batch (``cache_pspecs``): a rank updates its rows and gathers them
over ``data`` (``cache_rows``).  Mesh (1, 1) runs the unsharded arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.core._f32 import matmul_f32
from repro_torch.models.common import (Initializer, ShardCtx, block_of, conv_weight,
                                       embed_tokens, global_logits, head_block, local_rows,
                                       map_leaves, maybe_scan, qkv_heads, shard_linear,
                                       whole_cols, whole_rows)
from repro_torch.nn import attention as A
from repro_torch.nn import layers as L
from repro_torch.nn import rglru as RG

__all__ = ["init_params", "forward", "init_caches", "prefill", "decode_step"]


def _pattern(cfg: ArchConfig) -> tuple:
    pat = tuple(cfg.hybrid.pattern)
    n_groups = cfg.n_layers // len(pat)
    tail = cfg.n_layers - n_groups * len(pat)
    return pat, n_groups, tail


def _width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _init_mlp(cfg: ArchConfig, ini: Initializer) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    return {"w1": ini.dense((D, F_)), "w3": ini.dense((D, F_)),
            "w2": ini.dense((F_, D), fan_in=F_)}


def _init_recurrent(cfg: ArchConfig, ini: Initializer) -> dict:
    D, W = cfg.d_model, _width(cfg)
    dev = ini.device
    return {
        "rec_norm": torch.zeros((D,), device=dev),
        "rec_in": ini.dense((D, 2 * W)),  # [lru branch, gate branch]
        "conv_w": ini.normal((cfg.hybrid.conv_width, W)) * 0.1,
        "conv_b": torch.zeros((W,), device=dev),
        "w_a": ini.dense((W, W)),
        "b_a": torch.zeros((W,), device=dev),
        "w_x": ini.dense((W, W)),
        "b_x": torch.zeros((W,), device=dev),
        "lam": torch.linspace(0.5, 4.0, W, device=dev),  # decay ∈ (~0.6, ~0.999)
        "rec_out": ini.dense((W, D), fan_in=W),
        "ffn_norm": torch.zeros((D,), device=dev),
        "mlp": _init_mlp(cfg, ini),
    }


def _init_attention(cfg: ArchConfig, ini: Initializer) -> dict:
    D, hd = cfg.d_model, cfg.hd
    dev = ini.device
    return {
        "attn_norm": torch.zeros((D,), device=dev),
        "attn": {
            "wq": ini.dense((D, cfg.n_heads * hd)),
            "wk": ini.dense((D, cfg.n_kv_heads * hd)),
            "wv": ini.dense((D, cfg.n_kv_heads * hd)),
            "wo": ini.dense((cfg.n_heads * hd, D)),
        },
        "ffn_norm": torch.zeros((D,), device=dev),
        "mlp": _init_mlp(cfg, ini),
    }


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator],
                dtype=torch.float32, *, device=None) -> dict:
    """Seeded random weights on the generator's device (the JAX package's
    init laws).  ``device="meta"``: the shapes and dtypes only, no
    generator needed."""
    ini = Initializer(gen, device)
    pat, n_groups, tail = _pattern(cfg)
    dev = ini.device

    def group():
        return {f"l{i}": _init_recurrent(cfg, ini) if kind == "recurrent"
                else _init_attention(cfg, ini) for i, kind in enumerate(pat)}

    params = {
        "embed": ini.normal((cfg.vocab, cfg.d_model)) * 0.02,
        "groups": [group() for _ in range(n_groups)],
        "tail": [_init_recurrent(cfg, ini) for _ in range(tail)],
        "final_norm": torch.zeros((cfg.d_model,), device=dev),
        "lm_head": ini.dense((cfg.d_model, cfg.vocab)),
    }
    if dtype != torch.float32:
        params = map_leaves(lambda _, x: x.to(dtype), params)
    return params


# ---------------------------------------------------------------------------
# block forwards (full sequence)
# ---------------------------------------------------------------------------


def _mlp(x, p, impl: str, sctx: ShardCtx):
    def lin(a, w):
        return shard_linear(a, w, impl, sctx)

    return lin(L.swiglu(lin(x, p["w1"]), lin(x, p["w3"])), p["w2"])


def _ffn(x, p, cfg: ArchConfig, impl: str, sctx: ShardCtx):
    return x + _mlp(L.rms_norm(x, p["ffn_norm"], cfg.norm_eps), p["mlp"], impl, sctx)


def _gate(y, gate):
    """``y · gelu(gate)`` in f32, rounded once to ``y``'s dtype: the JAX
    package's product as XLA fuses it under ``jit`` (a bf16 product of a
    bf16 gelu moves the logits by several % of their max, through the
    RG-LRU gates of the next layers)."""
    return (y.float() * F.gelu(gate.float(), approximate="tanh")).to(y.dtype)


def _branches(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str) -> tuple:
    """``rec_in``'s output whole → ``(lru_in, gate)``, each this rank's
    block of the channels (all of them unsharded)."""
    W = _width(cfg)
    br = whole_cols(shard_linear(L.rms_norm(x, p["rec_norm"], cfg.norm_eps), p["rec_in"],
                                 impl, sctx), 2 * W, sctx)
    ch = block_of(W, conv_weight(p).shape[-1], sctx)
    if ch != slice(0, W):  # the whole output enters this rank's channels
        from repro_torch.launch.mesh import enter_split

        br = enter_split(br, sctx.mesh, sctx.model)
    return sctx.act_btf(br[..., :W][..., ch]), br[..., W:][..., ch]



def _gate_inputs(c, cfg: ArchConfig, sctx: ShardCtx) -> dict:
    """Under a mesh the gates read the whole conv output through their
    column blocks (``nn/rglru.py::_gates``)."""
    if not sctx.active:
        return {}
    return {"whole": whole_cols(c, _width(cfg), sctx),
            "linear": lambda a, w: shard_linear(a, w, "dequant", sctx)}


def _recurrent_fwd(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str) -> tuple:
    """Returns ``(x, (h_last, conv window))``: the states decode continues
    from (this rank's channels)."""
    lru_in, gate = _branches(x, p, cfg, sctx, impl)
    c = RG.causal_conv1d(lru_in, conv_weight(p), p["conv_b"])
    y, h_last = RG.rg_lru_scan(c, p, **_gate_inputs(c, cfg, sctx))
    x = x + shard_linear(_gate(y, gate), p["rec_out"], impl, sctx)
    return sctx.act_btd(_ffn(x, p, cfg, impl, sctx)), \
        (h_last, RG.conv_window(lru_in, cfg.hybrid.conv_width))


def _attention_fwd(x, p, cfg: ArchConfig, sctx: ShardCtx, impl: str, cos, sin) -> tuple:
    """Returns ``(x, (k, v))``: the roped keys and values, for the ring."""
    B, S, _ = x.shape
    xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    ap = p["attn"]
    hb = head_block(cfg, sctx)
    q, k, v = qkv_heads(xn, xn, ap, cfg, sctx, impl, hb)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    o = A.gqa_attention(sctx.act_bthd(q), *hb.kv(k, v), causal=True,
                        window=cfg.hybrid.local_window, chunk=min(1024, S))
    x = x + shard_linear(hb.out(o), ap["wo"], impl, sctx)
    return sctx.act_btd(_ffn(x, p, cfg, impl, sctx)), (k, v)


def _group_fwd(x, gp, cfg: ArchConfig, sctx: ShardCtx, impl: str, cos, sin) -> tuple:
    """One (R, R, A) group; returns ``(x, [each layer's states])``."""
    pat, _, _ = _pattern(cfg)
    states = []
    for i, kind in enumerate(pat):
        if kind == "recurrent":
            x, st = _recurrent_fwd(x, gp[f"l{i}"], cfg, sctx, impl)
        else:
            x, st = _attention_fwd(x, gp[f"l{i}"], cfg, sctx, impl, cos, sin)
        states.append(st)
    return x, states


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


def _rope_seq(S: int, cfg: ArchConfig, device) -> tuple:
    cos, sin = L.rope(torch.arange(S, device=device), cfg.hd, cfg.rope_theta)
    return cos[None], sin[None]


def forward(params: dict, tokens: torch.Tensor, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), *, frontend_embeds=None,
            logits_block: bool = False) -> tuple:
    """Full forward (training / prefill-style).  Returns ``(logits, {})``:
    global on every rank, or with ``logits_block`` this rank's block.
    With ``cfg.remat`` a differentiated call recomputes each group in the
    backward."""
    del frontend_embeds
    x = _embed(params, tokens, sctx)
    cos, sin = _rope_seq(x.shape[1], cfg, x.device)
    impl = _impl(cfg)

    def group(h, gp):
        return _group_fwd(h, gp, cfg, sctx, impl, cos, sin)[0]

    def body(h, gp):
        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(group, h, gp, use_reentrant=False), None
        return group(h, gp), None

    x, _ = maybe_scan(body, x, params["groups"], cfg.scan_layers)
    for p in params["tail"]:
        x, _ = _recurrent_fwd(x, p, cfg, sctx, impl)
    return _head(params, x, cfg, impl, sctx, logits_block), {}


# ---------------------------------------------------------------------------
# decode: ring-buffer local-attention cache + LRU/conv states
# ---------------------------------------------------------------------------


def init_caches(cfg: ArchConfig, batch: int, seq: int, dtype=torch.bfloat16, *,
                device=None) -> dict:
    """Per recurrent layer the LRU state and conv window; per attention
    layer a ring of ``min(local_window, seq)`` slots; on ``device``
    (default the card; ``"meta"`` for shapes only).  Under a mesh
    ``place_caches`` holds the states' channel blocks (whole on the batch),
    the ring's batch rows and its heads or slots over ``model``, and
    ``slot_pos``/``pos`` whole."""
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(device)
    pat, n_groups, tail = _pattern(cfg)
    W = _width(cfg)
    win = min(cfg.hybrid.local_window, seq)

    def rec():
        return {"h": torch.zeros((batch, W), dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch, cfg.hybrid.conv_width - 1, W), dtype=dtype,
                                    device=dev)}

    def attn():
        return {
            "k": torch.zeros((batch, win, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=dev),
            "v": torch.zeros((batch, win, cfg.n_kv_heads, cfg.hd), dtype=dtype, device=dev),
            # absolute position per ring slot, per batch row (-1 = empty)
            "slot_pos": torch.full((batch, win), -1, dtype=torch.int32, device=dev),
        }

    return {
        "groups": [{f"l{i}": rec() if kind == "recurrent" else attn()
                    for i, kind in enumerate(pat)} for _ in range(n_groups)],
        "tail": [rec() for _ in range(tail)],
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),  # per slot
    }


def _recurrent_step(x, p, cfg: ArchConfig, impl: str, cache: dict, sctx: ShardCtx) -> tuple:
    lru_in, gate = _branches(x, p, cfg, sctx, impl)
    c_out, new_win = RG.conv1d_decode_step(lru_in, conv_weight(p), p["conv_b"],
                                           local_rows(cache["conv"], sctx))
    y, h_new = RG.rg_lru_decode_step(c_out, p, local_rows(cache["h"], sctx),
                                     **_gate_inputs(c_out, cfg, sctx))
    x = x + shard_linear(_gate(y, gate), p["rec_out"], impl, sctx)
    return _ffn(x, p, cfg, impl, sctx), {"h": whole_rows(h_new, sctx),
                                         "conv": whole_rows(new_win, sctx)}


def _ring_block(cache: dict, sctx: ShardCtx) -> tuple:
    """``(offset, win)``: the first ring slot this rank's ``k``/``v`` hold and
    the ring's size (``slot_pos`` is whole: its width is the ring's)."""
    win, held = cache["slot_pos"].shape[1], cache["k"].shape[1]
    return block_of(win, held, sctx).start, win


def _attention_step(x, p, cfg: ArchConfig, impl: str, cache: dict, pos, cos, sin,
                    sctx: ShardCtx) -> tuple:
    """x: (B, D) one token.  Each batch row writes its own ring slot, then
    attends over the slots holding its last ``win`` positions.  ``pos`` is
    every row's position (``slot_pos`` is whole on the batch); a ring whose
    slots split over ``model`` writes the rank's slots and combines the
    ranks' softmax partials."""
    hd, KV = cfg.hd, cfg.n_kv_heads
    off, win = _ring_block(cache, sctx)
    held = cache["k"].shape[1]
    xn = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    ap = p["attn"]
    hb = head_block(cfg, sctx, decode=True)
    q, k, v = (t[:, None] for t in qkv_heads(xn, xn, ap, cfg, sctx, impl, hb))
    B, _, H, _ = q.shape
    mine = local_rows(pos, sctx)
    q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    every = (torch.arange(pos.shape[0], device=x.device), (pos % win).long())
    spos = cache["slot_pos"].index_put(every, pos.to(torch.int32))
    if held == win:
        at = (torch.arange(B, device=x.device), (mine % win).long())
        ck = cache["k"].index_put(at, k[:, 0].to(cache["k"].dtype))
        cv = cache["v"].index_put(at, v[:, 0].to(cache["v"].dtype))
    else:  # this rank's slots of the ring: the rows whose slot lies there
        hit = (off + torch.arange(held, device=x.device))[None, :] == (mine % win)[:, None]
        hit = hit[:, :, None, None]
        ck = torch.where(hit, k.to(cache["k"].dtype), cache["k"])
        cv = torch.where(hit, v.to(cache["v"].dtype), cache["v"])
    # masked attention over the ring buffer (invalid / out-of-window masked)
    sp = local_rows(spos, sctx)[:, off:off + held]
    qg = q.reshape(B, KV, H // KV, hd).float()
    s = matmul_f32(qg, ck.permute(0, 2, 3, 1).float()) * hd ** -0.5  # (B,KV,G,held)
    valid = (sp >= 0) & (sp >= mine[:, None] - win + 1) & (sp <= mine[:, None])
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=x.device))
    if held == win:
        pw = torch.softmax(s, dim=-1)
        o = matmul_f32(pw.to(cv.dtype).float(), cv.permute(0, 2, 1, 3).float())  # (B,KV,G,hd)
    else:
        o = A.combine_over(*A.softmax_partial(s, cv), sctx.mesh)
    o = o.reshape(B, H * hd).to(x.dtype)
    x = x + shard_linear(o, ap["wo"], impl, sctx)
    return _ffn(x, p, cfg, impl, sctx), {"k": ck, "v": cv, "slot_pos": spos}


def decode_step(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
                sctx: ShardCtx = ShardCtx()) -> tuple:
    """One autoregressive step.  ``tokens (B, 1)``; returns ``(logits (B, 1,
    V), caches)``; RoPE and the ring slot take each slot's own position."""
    pat, _, _ = _pattern(cfg)
    pos = caches["pos"]
    x = _embed(params, tokens, sctx)[:, 0]
    cos, sin = L.rope(local_rows(pos, sctx), cfg.hd, cfg.rope_theta)
    cos, sin = cos[:, None], sin[:, None]  # (B, 1, hd/2): per-slot rope
    impl = _impl(cfg)

    def body(h, inp):
        gp, gc = inp
        new_gc = {}
        for i, kind in enumerate(pat):
            key = f"l{i}"
            if kind == "recurrent":
                h, new_gc[key] = _recurrent_step(h, gp[key], cfg, impl, gc[key], sctx)
            else:
                h, new_gc[key] = _attention_step(h, gp[key], cfg, impl, gc[key], pos,
                                                 cos, sin, sctx)
        return h, new_gc

    x, new_groups = maybe_scan(body, x, list(zip(params["groups"], caches["groups"])),
                               cfg.scan_layers)
    new_tail = []
    for p, c in zip(params["tail"], caches["tail"]):
        x, nc = _recurrent_step(x, p, cfg, impl, c, sctx)
        new_tail.append(nc)
    logits = _head(params, x, cfg, impl, sctx)[:, None, :]
    return logits, {"groups": new_groups or [], "tail": new_tail, "pos": pos + 1}


def _fill_rec(state, cache: dict, sctx: ShardCtx) -> dict:
    h_last, win = state
    return {"h": whole_rows(h_last, sctx),
            "conv": whole_rows(win.to(cache["conv"].dtype), sctx)}


def _fill_attn(kv, cache: dict, sctx: ShardCtx) -> dict:
    """Write the last ``win`` positions of a prompt into the ring buffer
    (this rank's slots of it when they split over ``model``)."""
    k, v = kv
    off, win = _ring_block(cache, sctx)
    held, S = cache["k"].shape[1], k.shape[1]
    n = min(S, win)
    # the slots follow from the shapes alone: worked out on the host, so a
    # shape-only (meta) prefill needs no data-dependent selection
    pos = torch.arange(S - n, S)
    slots = pos % win
    ck, cv, spos = cache["k"].clone(), cache["v"].clone(), cache["slot_pos"].clone()
    spos[:, slots.to(spos.device)] = pos.to(spos.device, spos.dtype)
    k, v = k[:, -n:], v[:, -n:]
    if held != win:  # the positions whose slots this rank holds
        own = ((slots >= off) & (slots < off + held)).nonzero()[:, 0]
        slots, k, v = slots[own] - off, k[:, own.to(k.device)], v[:, own.to(k.device)]
    ck[:, slots.to(ck.device)] = k.to(ck.dtype)
    cv[:, slots.to(cv.device)] = v.to(cv.dtype)
    return {"k": ck, "v": cv, "slot_pos": spos}


def prefill(params: dict, tokens: torch.Tensor, caches: dict, cfg: ArchConfig,
            sctx: ShardCtx = ShardCtx(), **kw) -> tuple:
    """Prompt pass: the full-sequence forward, keeping the decode states.
    Returns ``(logits of the last position (B, 1, V), caches)``.

    Right-padded prompts (``lengths=``) are NOT supported: the RG-LRU scan
    folds every input token into recurrent state, so pad tokens would
    corrupt it.  Serve hybrid slots with exact-length prompts (bucket
    granularity 1).
    """
    if kw.get("lengths") is not None:
        raise ValueError("hybrid.prefill: padded prompts (lengths=) unsupported — "
                         "the RG-LRU scan would absorb pad tokens into state")
    pat, _, _ = _pattern(cfg)
    x = _embed(params, tokens, sctx)
    S = x.shape[1]
    cos, sin = _rope_seq(S, cfg, x.device)
    impl = _impl(cfg)

    def body(h, inp):
        gp, gc = inp
        h, states = _group_fwd(h, gp, cfg, sctx, impl, cos, sin)
        return h, {f"l{i}": (_fill_rec if kind == "recurrent" else _fill_attn)(
            st, gc[f"l{i}"], sctx) for i, (kind, st) in enumerate(zip(pat, states))}

    x, new_groups = maybe_scan(body, x, list(zip(params["groups"], caches["groups"])),
                               cfg.scan_layers)
    new_tail = []
    for p, c in zip(params["tail"], caches["tail"]):
        x, st = _recurrent_fwd(x, p, cfg, sctx, impl)
        new_tail.append(_fill_rec(st, c, sctx))
    logits = _head(params, x[:, -1:], cfg, impl, sctx)
    return logits, {"groups": new_groups or [], "tail": new_tail, "pos": caches["pos"] + S}
