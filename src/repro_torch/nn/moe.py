"""Mixture-of-Experts: top-k routing, sort-based dispatch, per-expert GEMMs.

Port of ``repro.nn.moe``.  Tokens are grouped (``n_groups``, the JAX
package's DP degree); each group sorts only its own tokens by expert, a
``searchsorted`` over the run starts gives each entry its position within
its expert, and entries past the capacity are dropped.  The only scatter
builds an ``(E, C)`` int slot→token map, each kept slot written once;
every ``D``-wide movement is a gather, so dispatch and combine are
deterministic on the card.

Weights follow DeepSeek-MoE: ``n_shared`` always-on experts plus
``n_experts`` routed experts with top-k softmax gating.  The router stays
dense (f32).  Quantized expert stacks are ``PasmParams`` with a leading E,
each expert with its own dictionaries: under ``kernel``/``pas_kernel``
every expert is one :func:`repro_torch.core.params.matmul` call (K1 or K3
on the card) on its slice (:meth:`PasmParams.select`, a view); otherwise
the stack dequantizes (:func:`repro_torch.core.params.dense_stack`) into
one batched product.  The JAX package's sharding constraints are not
ported: the port has no mesh.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import params as _params
from repro_torch.core._f32 import matmul_f32
from repro_torch.nn import layers as L

__all__ = ["moe_ffn", "expert_ffn", "capacity", "route"]

def expert_ffn(x: torch.Tensor, w1, w3, w2, act: str, impl: str) -> torch.Tensor:
    """SwiGLU / squared-ReLU / GELU FFN, for the shared experts."""
    if act == "swiglu":
        h = L.swiglu(L.linear(x, w1, impl), L.linear(x, w3, impl))
    elif act == "sq_relu":
        h = L.sq_relu(L.linear(x, w1, impl))
    else:
        h = L.gelu_ffn_act(L.linear(x, w1, impl))
    return L.linear(h, w2, impl)


def _expert_matmul(bufT, w, dt, impl):
    """Per-expert batched matmul ``(E, T, K) @ (E, K, N) → (E, T, N)``.

    Quantized experts under a kernel impl run one fused-dequant GEMM per
    expert, each slice dereferencing its own dictionaries.  Otherwise the
    stack dequantizes to ``dt`` and one batched product takes it, summed
    in f32 (the JAX einsum's accumulation) and rounded to ``dt``.
    """
    if _params.is_quantized(w) and impl in ("kernel", "pas_kernel"):
        p = _params.as_params(w)
        return torch.stack([
            _params.matmul(bufT[e], p.select(e), impl=impl)
            for e in range(bufT.shape[0])
        ]).to(dt)
    wd = _params.dense_stack(w, dt)
    return matmul_f32(bufT.float(), wd.float()).to(dt)


def capacity(T: int, cfg: MoEConfig, *, dropless: bool, n_groups: int = 1) -> tuple:
    """``(n_groups, cap)``: the groups actually used (1 when they do not
    divide ``T``) and each expert's slots per group.  Dropless keeps every
    entry up to 512 tokens a group, and above that 1.25× the balanced
    load; otherwise ``capacity_factor`` × the balanced load."""
    E, k = cfg.n_experts, cfg.top_k
    if T % n_groups:
        n_groups = 1
    Tl = T // n_groups
    if dropless:
        cap = Tl if Tl <= 512 else min(Tl, -(-Tl * k * 5 // (E * 4)))
    else:
        cap = int(max(1, round(Tl * k / E * cfg.capacity_factor)))
    return n_groups, min(cap, Tl)


def route(x: torch.Tensor, router: torch.Tensor, k: int) -> tuple:
    """Dense f32 routing: ``(probs (T, E), top_w (T, k), top_i (T, k))``,
    the gates renormalised over the k chosen.  Ties go to the lower expert
    index, as ``jax.lax.top_k`` does (a stable descending sort)."""
    logits = matmul_f32(x.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def _dispatch(xl: torch.Tensor, il: torch.Tensor, E: int, cap: int) -> tuple:
    """One group: ``(Tl, D)``, ``(Tl, k)`` → buffer ``(E, C, D)`` and the
    combine's ``(pos, keep)``, both ``(Tl, k)``."""
    Tl, k = il.shape
    dev = il.device
    e_flat = il.reshape(-1)
    order = torch.sort(e_flat, stable=True).indices
    e_sorted = e_flat[order]
    tok_sorted = torch.div(order, k, rounding_mode="floor")
    run_starts = torch.searchsorted(e_sorted, torch.arange(E, device=dev), side="left")
    pos = torch.arange(Tl * k, device=dev) - run_starts[e_sorted]
    keep = pos < cap
    pos_c = torch.where(keep, pos, torch.zeros_like(pos))
    # slot → token + 1 (0 = empty).  Dropped entries go to an extra row E
    # that is cut off (JAX's mode="drop"), so every kept (expert, slot) is
    # written once, and no mask is read back to the host
    slot_tok = torch.zeros((E + 1, cap), dtype=torch.long, device=dev)
    rows = torch.where(keep, e_sorted, torch.full_like(e_sorted, E))
    slot_tok[rows, pos_c] = tok_sorted + 1
    slot_tok = slot_tok[:E]
    buf = xl[torch.clamp(slot_tok - 1, min=0)]  # (E, C, D) gather
    buf = buf * (slot_tok > 0)[..., None].to(xl.dtype)
    pos_u = torch.empty_like(pos_c)
    pos_u[order] = pos_c
    keep_u = torch.empty_like(keep)
    keep_u[order] = keep
    return buf, pos_u.reshape(Tl, k), keep_u.reshape(Tl, k)


def moe_ffn(
    x: torch.Tensor,
    params: dict,
    cfg: MoEConfig,
    *,
    act: str = "swiglu",
    impl: str = "dense",
    dropless: bool = False,
    n_groups: int = 1,
) -> tuple:
    """``x (T, D) → (T, D)``, aux metrics.

    ``n_groups``: local-dispatch groups (each sorts only its own tokens).
    ``aux`` holds ``moe_load_balance`` and ``moe_drop_frac`` when not
    ``dropless``, and is empty when serving.
    """
    T, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    n_groups, cap = capacity(T, cfg, dropless=dropless, n_groups=n_groups)
    Tl = T // n_groups

    probs, top_w, top_i = route(x, params["router"], k)
    xg = x.reshape(n_groups, Tl, D)
    ig = top_i.reshape(n_groups, Tl, k)
    wg = top_w.reshape(n_groups, Tl, k)
    groups = [_dispatch(xg[g], ig[g], E, cap) for g in range(n_groups)]
    buf = torch.stack([b for b, _, _ in groups])  # (G, E, C, D)

    dt = x.dtype
    bufT = buf.transpose(0, 1).reshape(E, n_groups * cap, D)
    h = _expert_matmul(bufT, params["w1"], dt, impl)
    if act == "swiglu":
        h = L.swiglu(h, _expert_matmul(bufT, params["w3"], dt, impl))
    elif act == "sq_relu":
        h = L.sq_relu(h)
    else:
        h = L.gelu_ffn_act(h)
    y2 = _expert_matmul(h, params["w2"], dt, impl)
    yb = y2.reshape(E, n_groups, cap, D).transpose(0, 1)  # (G, E, C, D)

    ys = []
    for g, (_, pos_u, keep_u) in enumerate(groups):
        il, wl, ybl = ig[g], wg[g], yb[g]
        y = torch.zeros((Tl, D), dtype=ybl.dtype, device=x.device)
        for j in range(k):  # k gathers of (Tl, D)
            contrib = ybl[il[:, j], pos_u[:, j]]
            gate = (wl[:, j] * keep_u[:, j]).to(ybl.dtype)
            y = y + contrib * gate[:, None]
        ys.append(y)
    y = torch.cat(ys)

    if "shared_w1" in params:
        y = y + expert_ffn(x, params["shared_w1"], params["shared_w3"],
                           params["shared_w2"], act, impl)

    if dropless:
        aux = {}
    else:
        me = probs.mean(dim=0)
        # integer counts: exact, and deterministic on the card
        ce = torch.bincount(top_i.reshape(-1), minlength=E).float() / (T * k)
        keep_frac = torch.stack([kp for _, _, kp in groups]).float().mean()
        aux = {"moe_load_balance": E * torch.sum(me * ce),
               "moe_drop_frac": 1.0 - keep_frac}
    return y.to(x.dtype), aux
