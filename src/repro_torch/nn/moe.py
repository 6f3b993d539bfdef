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
one batched product.

Under a mesh (``mesh=``) the experts run SPMD, as the JAX package's
sharding constraints lay them out (``src/repro/nn/moe.py``): each rank
dispatches its own group of tokens and holds its block of the placed
expert stacks (``models/sharding.py::place_params``: E over ``model``,
the FFN dim ``Fe`` over ``data``).  Up to 4096 tokens the ``Fe``-sharded
weights stay in place: the groups' buffers are gathered over ``data``,
each rank computes its ``Fe`` block for every token, and the outputs are
summed over ``data`` in f32.  Above it the int4 weights are gathered over
``data`` (the indices move, not dense matrices) and each rank computes
its own tokens.  The combine adds each token's k experts, which live on
different ``model`` ranks: a partial sum in f32 a rank, all-reduced over
``model``.  The shared experts are column/row-parallel over ``model``;
the router is replicated.  A reduction over an axis of size 1 is not
taken, so mesh (1, 1) computes the one-device function bitwise.

The backward follows the collectives' pairing (``launch/mesh.py``): where
a tensor replicated over an axis enters rank-distinct work it passes
``enter_split``, so its gradient is summed over that axis.  Over
``model``, with the experts split there, that is the tokens entering the
dispatch and the gates entering the partial combine (the router's
gradient is then whole on every rank; its load-balance term reads the
probabilities replicated); over ``data``, in the ``Fe``-block regime,
the summed expert outputs before a rank keeps its own group's rows, and
above the switch the dense expert weights gathered for a rank's tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import params as _params
from repro_torch.core._f32 import matmul_f32
from repro_torch.nn import layers as L

__all__ = ["moe_ffn", "expert_ffn", "capacity", "route", "GATHER_WEIGHTS_T"]

DATA, MODEL = "data", "model"
# the regime switch (JAX's ``gather_weights = T > 4096``): above this many
# tokens a call gathers the Fe-sharded weights over data instead of
# reducing the expert outputs over it
GATHER_WEIGHTS_T = 4096


def _ffn(x: torch.Tensor, mm, act: str) -> torch.Tensor:
    """SwiGLU / squared-ReLU / GELU FFN over a per-matrix product ``mm(x,
    name)``, ``name`` one of ``w1``, ``w3``, ``w2``."""
    h = mm(x, "w1")
    if act == "swiglu":
        h = L.swiglu(h, mm(x, "w3"))
    elif act == "sq_relu":
        h = L.sq_relu(h)
    else:
        h = L.gelu_ffn_act(h)
    return mm(h, "w2")


def expert_ffn(x: torch.Tensor, w1, w3, w2, act: str, impl: str, *, mesh=None,
               rows: Optional[int] = None) -> torch.Tensor:
    """The FFN of the shared experts; ``mesh`` runs ``w1``/``w3`` column-
    and ``w2`` row-parallel on this rank's ``rows``-row block of the
    unsharded call (``params.tp_linear``)."""
    ws = {"w1": w1, "w3": w3, "w2": w2}
    if mesh is None:
        return _ffn(x, lambda h, n: L.linear(h, ws[n], impl), act)
    return _ffn(x, lambda h, n: _params.tp_linear(h, ws[n], impl=impl, mesh=mesh,
                                                  rows=rows), act)


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


def _expert_block_matmul(bufT, w, dt, impl, mesh, rows: int):
    """:func:`_expert_matmul` under a mesh: ``w`` is this rank's expert
    block with its own dictionaries (:func:`_own_experts`) and ``bufT`` its
    experts' buffers; each GEMM runs on the held ``Fe`` block
    (``params.block_matmul`` over ``data``, planned from ``rows``, the
    unsharded call's).  A K block's f32 partials are summed over ``data``
    before the one rounding to ``dt``."""
    from repro_torch.launch.mesh import all_reduce

    p = _params.as_params(w)
    if _params.is_quantized(p) and impl in ("kernel", "pas_kernel"):
        outs = [_params.block_matmul(bufT[e], p.select(e), impl=impl, mesh=mesh,
                                     axis=DATA, rows=rows)
                for e in range(bufT.shape[0])]
        y, split = torch.stack([o for o, _ in outs]), outs[0][1]
    else:
        y, split = _params.block_matmul(bufT, p, impl=impl, mesh=mesh, axis=DATA,
                                        rows=rows)
    if split:
        y = all_reduce(y, mesh, DATA)
    return y.to(dt)


def _own_experts(w, e0: int, n: int):
    """The held expert block ``[e0, e0 + n)`` with its own dictionaries: a
    placed stack holds every expert's codebooks (replicated, as the spec
    says) beside its own experts' indices."""
    p = _params.as_params(w)
    if p.codebook is not None and p.codebook.shape[0] != n:
        p = dataclasses.replace(p, codebook=p.codebook[e0:e0 + n])
    return p


def _gather_ff(w, mesh):
    """The stack with its held ``Fe`` block gathered over ``data``: JAX's
    just-in-time weight gather (its ``spec`` on the stored weight), which
    moves the int4 indices."""
    from repro_torch.launch.mesh import all_gather

    p = _params.as_params(w)
    pb, k_split = _params.held_block(p, mesh, DATA)
    dim = -2 if k_split else -1
    if not k_split and pb.shape[1] == p.shape[1]:
        return p
    from repro_torch.launch.mesh import enter_split

    field = "w" if p.kind == "dense" else "idx"
    # a dense stack's gathered weights enter this rank's own tokens
    return dataclasses.replace(p, **{field: enter_split(
        all_gather(getattr(p, field), mesh, DATA, dim=dim), mesh, DATA)})


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


def _combine(yb, ig, wg, groups, dt, e0: int = 0, partial: bool = False) -> torch.Tensor:
    """Each token's k gated expert outputs, group after group: ``yb (G, E,
    C, D)``.  ``partial``: ``yb`` holds the experts ``[e0, e0 + E)`` only;
    the others' terms are left out and the sum is taken in f32, for the
    caller to add over ``model``."""
    ys = []
    for g, (_, pos_u, keep_u) in enumerate(groups):
        il, wl, ybl = ig[g], wg[g], yb[g]
        Tl, D = il.shape[0], ybl.shape[-1]
        if not partial:
            y = torch.zeros((Tl, D), dtype=ybl.dtype, device=ybl.device)
            for j in range(il.shape[1]):  # k gathers of (Tl, D)
                contrib = ybl[il[:, j], pos_u[:, j]]
                gate = (wl[:, j] * keep_u[:, j]).to(ybl.dtype)
                y = y + contrib * gate[:, None]
        else:
            y = torch.zeros((Tl, D), dtype=torch.float32, device=ybl.device)
            for j in range(il.shape[1]):
                e = il[:, j] - e0
                mine = (e >= 0) & (e < ybl.shape[0])
                contrib = ybl[torch.where(mine, e, torch.zeros_like(e)), pos_u[:, j]]
                gate = (wl[:, j] * keep_u[:, j] * mine).to(dt)
                y = y + contrib.float() * gate.float()[:, None]
        ys.append(y)
    return torch.cat(ys)


def _experts_sharded(buf, params, cfg: MoEConfig, act: str, impl: str, mesh, *,
                     T: int, n_groups: int, cap: int, own_group: bool) -> tuple:
    """The routed experts on this rank's block (module docstring): ``buf
    (G_l, E, C, D)`` → ``(yb (G_l, E_l, C, D), e0)``, the held experts'
    outputs for the held groups' tokens."""
    from repro_torch.launch.mesh import all_gather

    E = cfg.n_experts
    G_l, _, C, D = buf.shape
    dt = buf.dtype
    E_l = _params.as_params(params["w1"])._lead[0]
    e0 = mesh.index(MODEL) * E_l if E_l < E else 0
    ws = {n: _own_experts(params[n], e0, E_l) for n in ("w1", "w3", "w2") if n in params}
    w1 = _params.as_params(ws["w1"])
    ff_split = _params.held_block(w1, mesh, DATA)[0].shape[1] < w1.shape[1]
    gather_buf = ff_split and T <= GATHER_WEIGHTS_T and own_group
    if ff_split and T > GATHER_WEIGHTS_T:
        ws = {n: _gather_ff(w, mesh) for n, w in ws.items()}
    bufT = buf[:, e0:e0 + E_l].transpose(0, 1).reshape(E_l, G_l * C, D)
    if gather_buf:  # every group's tokens, for this rank's Fe block
        bufT = all_gather(bufT, mesh, DATA, dim=1)
    rows = n_groups * cap  # the unsharded expert GEMMs' rows
    y2 = _ffn(bufT, lambda h, n: _expert_block_matmul(h, ws[n], dt, impl, mesh, rows), act)
    if gather_buf:  # back to this rank's own group
        from repro_torch.launch.mesh import enter_split

        y2 = enter_split(y2, mesh, DATA).narrow(1, mesh.index(DATA) * C, C)
    return y2.reshape(E_l, G_l, C, D).transpose(0, 1), e0


def _expert_counts(top_i: torch.Tensor, E: int) -> torch.Tensor:
    """Rows routed to each of ``E`` experts, exact integers: ``bincount``'s
    counts from a sort and two searches, whose length follows from ``E``
    alone (so a shape-only run has them too), deterministic on the card."""
    s = torch.sort(top_i.reshape(-1)).values
    e = torch.arange(E, device=s.device, dtype=s.dtype)
    return torch.searchsorted(s, e, right=True) - torch.searchsorted(s, e)


def moe_ffn(
    x: torch.Tensor,
    params: dict,
    cfg: MoEConfig,
    *,
    act: str = "swiglu",
    impl: str = "dense",
    dropless: bool = False,
    n_groups: int = 1,
    mesh=None,
    group_spec: Optional[tuple] = None,
) -> tuple:
    """``x (T, D) → (T, D)``, aux metrics.

    ``n_groups``: local-dispatch groups (each sorts only its own tokens).
    ``aux`` holds ``moe_load_balance`` and ``moe_drop_frac`` when not
    ``dropless``, and is empty when serving.

    ``mesh`` runs the experts SPMD (module docstring) on params placed by
    ``models/sharding.py::place_params``; ``group_spec`` names the axes the
    group dim shards over, as in the JAX package: with ``("data",)`` ``x``
    is this rank's own group of the ``n_groups``, else every token.  The
    output and aux are this rank's tokens' and the global ones.
    """
    from repro_torch.launch.mesh import all_reduce, enter_split

    own_group = mesh is not None and bool(group_spec) and group_spec[0] is not None
    T_l, D = x.shape
    T = T_l * n_groups if own_group else T_l
    E, k = cfg.n_experts, cfg.top_k
    n_groups, cap = capacity(T, cfg, dropless=dropless, n_groups=n_groups)
    G_l = 1 if own_group else n_groups
    Tl = T_l // G_l

    probs, top_w, top_i = route(x, params["router"], k)
    xd, gates = x, top_w
    if mesh is not None and _params.as_params(params["w1"])._lead[0] < E:
        # this rank's experts: the replicated tokens and gates enter them
        xd, gates = enter_split(x, mesh, MODEL), enter_split(top_w, mesh, MODEL)
    xg = xd.reshape(G_l, Tl, D)
    ig = top_i.reshape(G_l, Tl, k)
    wg = gates.reshape(G_l, Tl, k)
    groups = [_dispatch(xg[g], ig[g], E, cap) for g in range(G_l)]
    buf = torch.stack([b for b, _, _ in groups])  # (G, E, C, D)

    dt = x.dtype
    if mesh is None:
        bufT = buf.transpose(0, 1).reshape(E, n_groups * cap, D)
        y2 = _ffn(bufT, lambda h, n: _expert_matmul(h, params[n], dt, impl), act)
        yb = y2.reshape(E, n_groups, cap, D).transpose(0, 1)  # (G, E, C, D)
        y = _combine(yb, ig, wg, groups, dt)
    else:
        yb, e0 = _experts_sharded(buf, params, cfg, act, impl, mesh, T=T,
                                  n_groups=n_groups, cap=cap, own_group=own_group)
        partial = yb.shape[1] < E
        y = _combine(yb, ig, wg, groups, dt, e0, partial=partial)
        if partial:
            y = all_reduce(y, mesh, MODEL).to(dt)

    if "shared_w1" in params:
        y = y + expert_ffn(x, params["shared_w1"], params["shared_w3"],
                           params["shared_w2"], act, impl, mesh=mesh, rows=T)

    if dropless:
        aux = {}
    elif own_group:
        # the global means: this group's sums added over data
        kept = torch.stack([kp for _, _, kp in groups]).float().sum()
        s = all_reduce(torch.cat([probs.sum(dim=0),
                                  _expert_counts(top_i, E).float(),
                                  kept[None]]), mesh, DATA)
        me, ce = s[:E] / T, s[E:2 * E] / (T * k)
        aux = {"moe_load_balance": E * torch.sum(me * ce),
               "moe_drop_frac": 1.0 - s[-1] / (T * k)}
    else:
        me = probs.mean(dim=0)
        # integer counts: exact, and deterministic on the card
        ce = _expert_counts(top_i, E).float() / (T * k)
        keep_frac = torch.stack([kp for _, _, kp in groups]).float().mean()
        aux = {"moe_load_balance": E * torch.sum(me * ce),
               "moe_drop_frac": 1.0 - keep_frac}
    return y.to(x.dtype), aux
