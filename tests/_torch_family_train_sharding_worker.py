"""The ranks of ``tests/test_torch_family_train_sharding.py``: one process a rank on gloo.

Each rank builds the ``("data", "model")`` mesh and trains, under an active
``ShardCtx``, the smoke configs of every LM family the dense one did not
cover (``MODELS``: deepseek-moe-16b, internvl2-26b, mamba2-130m,
recurrentgemma-2b, whisper-tiny, phi3-medium-14b with its 5 KV heads cut by
``model``, qwen3-32b with one KV head beside its per-head norms and with 6 q
heads over 3 KV heads; at (1, 4) qwen3-32b's smoke and the 6-head variant),
on ``dequant`` and ``kernel``, and holds every result against the port's
one-device step in its own process; what each check returned (or its
traceback) goes to ``rank<r>.pkl``.  No JAX here: the parent hands the JAX
weights and the batches over as numpy (``cases.pkl``) and holds the
gathered gradients against the JAX package's unsharded step.

Every model runs f32 activations (the modules' ``_ACT``, as
``tests/_torch_lm.py::f32_activations`` sets them in both packages), so a
sharded step differs from one device's only by the order of f32 sums: a
row-parallel partial added over ``model``, a gradient's rows added over
``data``.  Each such sum of ``n`` terms moves by at most ``n·2^-24`` of the
sum of their magnitudes; through a two-layer smoke model's backward that
stays under ``GRAD_TOL = 2^-12`` of a leaf's max (measured: at most 3.5e-6
on these configs), the loss under ``LOSS_TOL``.

The MoE's routing: a token whose top-k experts differ between the sharded
and the one-device run (another order of the router's input sums) must be a
near-tie, each expert taken within ``TIE`` (2^-5) of the k-th probability;
a flipped token reaches every leaf through the backward, so where one
flipped the gradients are not compared (the flips are counted and
returned).

Exactly: mesh (1, 1) (in the parent); a ZeRO-1 step against the step with
whole moments at the same mesh (params and the gathered moments bitwise,
each rank's moment blocks bitwise ``local_shard`` of the whole ones under
``zero_specs``); ``compress_grads(mesh=)`` against the rank's block of the
compressed gathered gradient; a ZeRO state saved at (2, 2) and restored at
(1, 2).  A failing comparison is recorded and raised at its check's end,
so the ranks stay in step through the collectives (gloo aborts a rank left
in one).
"""
from __future__ import annotations

import dataclasses
import pickle
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from _torch_heads import attended

from repro_torch import interop
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.models import sharding as tsh
from repro_torch.models.common import ShardCtx, head_block
from repro_torch.nn import moe as TM
from repro_torch.train import optimizer as opt
from repro_torch.train import step as st
from repro_torch.train.loop import run_loop
from repro_torch.tree import flatten_with_path, tree_leaves

COLLECTIVE_TIMEOUT_S = 30  # a rank out of step fails fast instead of hanging
GRAD_TOL = 2.0 ** -12
LOSS_TOL = 1e-5
TIE = 2.0 ** -5
B, S = 4, 8
IMPLS = ("dequant", "kernel")
# key -> (arch, config changes)
MODELS = {
    "moe": ("deepseek-moe-16b", {}),
    "vlm": ("internvl2-26b", {}),
    "ssm": ("mamba2-130m", {}),
    "hybrid": ("recurrentgemma-2b", {}),
    "encdec": ("whisper-tiny", {}),
    "kvcut": ("phi3-medium-14b", {}),  # 5 KV heads: model 2 cuts them
    "qknorm": ("qwen3-32b", {"n_kv_heads": 1}),  # q_norm / k_norm on 2 of 4 heads
    # 6 q heads over 3 KV heads: at model 2 a rank's 3 straddle a KV group
    "straddle": ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3}),
}
# the models the (1, 4) mesh trains: qwen3's smoke (one q head a rank) and
# the straddling variant (a block of 3 q heads on two ranks)
FOUR = {"gqa": ("qwen3-32b", {}), "straddle": MODELS["straddle"]}
OCFG = opt.AdamWConfig(lr=1e-2, total_steps=64, warmup_steps=1)
ELASTIC = "moe"  # the ZeRO state saved at (2, 2), restored at (1, 2)


def config(key: str, impl: str):
    arch, changes = {**MODELS, **FOUR}[key]
    return dataclasses.replace(get_config(arch, smoke=True), **changes).with_quant(
        enabled=True, impl=impl, min_weight_elems=1024)


def f32_activations() -> None:
    """Every LM module's activations in f32 (this process only)."""
    from repro_torch.models import encdec, hybrid, ssm_lm, transformer

    for m in (encdec, hybrid, ssm_lm, transformer):
        m._ACT = torch.float32


def params_of(case: dict):
    return interop.lm_params_from_numpy(case["params"], device="cpu")


def batch_of(case: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in case["batch"].items()}


def numpy_tree(tree) -> dict:
    return {"/".join(p): x.detach().float().numpy() if x.is_floating_point()
            else x.numpy() for p, x in flatten_with_path(tree)}


def same_tree(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


class Soft:
    """Comparison failures of one check, raised together at its end."""

    def __init__(self):
        self.errors = []

    def close(self, got, want, tol, what: str) -> float:
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        if got.shape != want.shape:
            self.errors.append(f"{what}: shape {got.shape} vs {want.shape}")
            return float("inf")
        scale = float(np.abs(want).max(initial=0.0))
        d = float(np.abs(got - want).max(initial=0.0))
        if not np.isfinite(got).all() or d > tol * scale:
            self.errors.append(f"{what}: max |Δ| {d:.3e} > {tol:g}·{scale:.3e}")
        return d / scale if scale else d

    def check(self, ok: bool, what: str) -> None:
        if not ok:
            self.errors.append(what)

    def done(self) -> None:
        if self.errors:
            raise AssertionError("\n".join(self.errors))


class Routes:
    """Records each MoE call's router probabilities and chosen experts
    (``nn/moe.py::route``) while active."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self.inner = TM.route

        def spy(x, router, k):
            probs, top_w, top_i = self.inner(x, router, k)
            self.calls.append((probs.detach().clone(), top_i.clone()))
            return probs, top_w, top_i

        TM.route = spy
        return self

    def __exit__(self, *exc):
        TM.route = self.inner


def flips(soft: Soft, got: Routes, want: Routes, rows: slice, k: int) -> int:
    """Tokens whose experts differ between ``got`` (this rank's ``rows``)
    and ``want`` (one device's), each checked to be a near-tie."""
    n = 0
    soft.check(len(got.calls) == len(want.calls),
               f"{len(got.calls)} MoE calls vs one device's {len(want.calls)}")
    for (_, gi), (pw, wi) in zip(got.calls, want.calls):
        pw, wi = pw[rows], wi[rows]
        differ = (gi.sort(-1).values != wi.sort(-1).values).any(-1)
        for t in torch.nonzero(differ).flatten().tolist():
            kth = float(pw[t].sort(descending=True).values[k - 1])
            extra = set(gi[t].tolist()) - set(wi[t].tolist())
            soft.check(all(float(pw[t, e]) >= kth * (1 - TIE) for e in extra),
                       f"token {t}: experts {gi[t].tolist()} vs {wi[t].tolist()}, "
                       "not a near-tie")
            n += 1
    return n


def grads_close(soft: Soft, got: dict, want: dict, tol: float, what: str) -> dict:
    """Each leaf within ``tol`` of its max; the worst |Δ| / max by leaf kind
    (the last path component: ``codebook``, ``w``, a norm's name, ...)."""
    soft.check(set(got) == set(want), f"{what}: grad leaves {sorted(set(got) ^ set(want))}")
    worst: dict = {}
    for k in sorted(set(got) & set(want)):
        kind = k.split("/")[-1]
        worst[kind] = max(worst.get(kind, 0.0), soft.close(got[k], want[k], tol,
                                                          f"{what} grad {k}"))
    return worst


def rank_rows(mesh, sctx) -> slice:
    """This rank's tokens of the flattened global batch."""
    if not sctx.batch_split:
        return slice(0, B * S)
    n = B * S // sctx.dp
    return slice(mesh.index("data") * n, (mesh.index("data") + 1) * n)


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def check_step(mesh, case: dict, key: str, impl: str) -> dict:
    """Loss and every gradient leaf (gathered) of the sharded step against
    one device's with the mesh's dispatch groups; the gathered gradients
    for the parent's JAX comparison; the collective bytes by key."""
    soft, out = Soft(), {}
    cfg = config(key, impl)
    params = params_of(case)
    batch = batch_of(case)
    sctx = ShardCtx.for_mesh(mesh, B)
    placed = tsh.place_params(params, mesh)
    with Routes() as r1:
        loss1, _, g1 = st.loss_and_grads(params, batch, cfg, ShardCtx(dp=sctx.dp))
    tmesh.reset_collective_bytes()
    with Routes() as r, attended() as calls:
        loss, _, g = st.loss_and_grads(placed, batch, cfg, sctx)
    out["bytes"] = dict(tmesh.collective_bytes)
    hb = head_block(cfg, sctx)
    out["heads"] = ((hb.q0, hb.nq), sorted(set(calls)))
    out["flips"] = flips(soft, r, r1, rank_rows(mesh, sctx), cfg.moe.top_k) if cfg.moe else 0
    soft.close(loss, loss1, LOSS_TOL, "loss")
    got = numpy_tree(tsh.gather_params(g, mesh))
    if not out["flips"]:
        out["worst"] = grads_close(soft, got, numpy_tree(g1), GRAD_TOL, f"{key} {impl}")
    out["grads"], out["loss"] = got, float(loss)
    if key == "qknorm" and mesh.size("model") > 1:  # 4 q heads: 2 a rank
        ax = tsh.grad_reduce_axes(placed, mesh)
        soft.check(ax[("layers", "0", "attn", "q_norm")] == ax[
            ("layers", "0", "attn_norm")] + ("model",), "q_norm not summed over model")
    soft.done()
    return out


def check_zero(mesh, case: dict, key: str) -> dict:
    """The step with JAX's ZeRO-1 moments against the step with whole ones
    at this mesh: the new params bitwise, the gathered moments bitwise,
    each rank's moment blocks bitwise ``local_shard`` of the whole ones
    under ``zero_specs``; the moment bytes a rank holds in both layouts."""
    soft = Soft()
    cfg = config(key, "dequant")
    placed = tsh.place_params(params_of(case), mesh)
    batch = batch_of(case)
    sctx = ShardCtx.for_mesh(mesh, B)
    step = st.make_train_step(cfg, OCFG, sctx)
    whole = opt.init_opt_state(placed)
    zero = opt.init_opt_state(placed, mesh=mesh)
    soft.check(isinstance(zero, opt.ZeroOptState), "init_opt_state(mesh=): not ZeRO")
    with st.deterministic():
        a = step(placed, whole, batch)
        tmesh.reset_collective_bytes()
        b = step(placed, zero, batch)
    nbytes = dict(tmesh.collective_bytes)
    soft.check(same_tree(a[0], b[0]), "ZeRO step: params differ from whole moments'")
    soft.check(torch.equal(a[2]["loss"], b[2]["loss"]) and torch.equal(
        a[2]["grad_norm"], b[2]["grad_norm"]), "ZeRO step: loss or grad norm differs")
    soft.check(same_tree(tsh.gather_params((a[0], a[1]), mesh),
                         tsh.gather_params((b[0], b[1]), mesh)),
               "ZeRO step: gathered moments differ")
    z = tsh.zero_specs(placed, mesh)
    glob = tsh.gather_params(a[1], mesh)  # the whole moments, logical
    for name in ("mu", "nu"):
        want = tsh.place_tree(getattr(glob, name), z, mesh, like=getattr(b[1], name))
        soft.check(same_tree(getattr(b[1], name), want),
                   f"ZeRO {name}: not local_shard of the whole moments by zero_specs")
    mb = lambda s: sum(t.numel() * t.element_size() for t in  # noqa: E731
                       tree_leaves((s.mu, s.nu)))
    soft.check(nbytes["zero_gather"] > 0 or mesh.size("data") == 1,
               "ZeRO step gathered no params")
    soft.done()
    return {"moment_bytes": mb(b[1]), "whole_bytes": mb(a[1]), "bytes": nbytes,
            "specs": {"/".join(p): tuple(s) for p, _, s, _ in tsh._walked(placed, z, mesh)}}


def check_compress(mesh, case: dict, key: str) -> dict:
    """``compress_grads(mesh=)`` on the rank's reduced blocks: bitwise its
    block of the compressed gathered gradient, and through the step."""
    soft = Soft()
    cfg = config(key, "dequant")
    placed = tsh.place_params(params_of(case), mesh)
    batch = batch_of(case)
    sctx = ShardCtx.for_mesh(mesh, B)
    _, _, g = st.loss_and_grads(placed, batch, cfg, sctx)
    tmesh.reset_collective_bytes()
    c = opt.compress_grads(g, 16, mesh=mesh)
    nbytes = dict(tmesh.collective_bytes)
    specs = tsh.placed_specs(placed, mesh)
    whole = opt.compress_grads(tsh.gather_params(g, mesh, specs), 16)
    soft.check(same_tree(c, tsh.place_tree(whole, specs, mesh, like=g)),
               "compress_grads(mesh=) is not the block of the gathered compression")
    soft.check(not same_tree(c, g), "compression changed nothing")
    new = st.make_train_step(cfg, OCFG, sctx, compress_grads_bins=16)(
        placed, opt.init_opt_state(placed), batch)
    soft.check(int(new[2]["skipped"]) == 0, "compressed step skipped")
    soft.done()
    return {"bytes": nbytes}


def check_fault_distinct(mesh, case: dict, key: str) -> dict:
    """The recurrent families' gathered activations feed rank-distinct
    work (a block of the channels, the scan on a P block, the gated norm's
    block): their gradients, reduced over the table's axes, against one
    device's, computed through the pieces the train step is built of."""
    soft = Soft()
    cfg = config(key, "dequant")
    params = params_of(case)
    batch = batch_of(case)
    sctx = ShardCtx.for_mesh(mesh, B)
    placed = tsh.place_params(params, mesh)
    model = api.get_model(cfg)
    _, _, g1 = st._value_and_grad(lambda p: st._lm_loss(p, batch, cfg, ShardCtx(), model),
                                  params)
    _, _, g = st._value_and_grad(lambda p: st._lm_loss(p, batch, cfg, sctx, model), placed)
    g = tsh.reduce_grads(g, tsh.grad_reduce_axes(placed, mesh), mesh)
    worst = grads_close(soft, numpy_tree(tsh.gather_params(g, mesh)), numpy_tree(g1),
                        GRAD_TOL, f"{key} pieces")
    soft.done()
    return {"worst": worst}


def check_elastic(mesh, case: dict, out_dir: Path) -> dict:
    """At (2, 2): two ZeRO steps of the MoE, checkpointed (the expert
    stacks' E and ``Fe`` blocks, the moments' ``data`` blocks).  At (1, 2):
    restored onto this mesh's ZeRO layout: every block bitwise this mesh's
    block of one device's restore, and the next step runs."""
    soft, out = Soft(), {}
    cfg = config(ELASTIC, "dequant")
    d = out_dir.parent / "elastic"
    sctx = ShardCtx.for_mesh(mesh, B)
    step = st.make_train_step(cfg, OCFG, sctx)
    params = params_of(case)
    placed = tsh.place_params(params, mesh)
    state = (placed, opt.init_opt_state(placed, mesh=mesh))
    batch = batch_of(case)
    if mesh.shape == (2, 2):
        mgr = ckpt.CheckpointManager(d, mesh=mesh)
        res = run_loop(step, state, lambda s: batch, steps=2, mgr=mgr, ckpt_every=2)
        soft.check(ckpt.complete_steps(d) == [2], f"saved {ckpt.complete_steps(d)}")
        out["saved"] = numpy_tree(tsh.gather_params(res.state, mesh))
    else:
        restored, man = ckpt.CheckpointManager(d, mesh=mesh).restore_latest(state)
        one, _ = ckpt.restore(d, (params, opt.init_opt_state(params)))
        soft.check(man["step"] == 2, f"restored step {man['step']}")
        soft.check(isinstance(restored[1], opt.ZeroOptState), "restored state not ZeRO")
        soft.check(same_tree(restored[0], tsh.place_params(one[0], mesh)),
                   "restored params are not this mesh's blocks of the logical ones")
        z = tsh.zero_specs(restored[0], mesh)
        for name in ("mu", "nu"):
            want = tsh.place_tree(getattr(one[1], name), z, mesh,
                                  like=getattr(restored[1], name))
            soft.check(same_tree(getattr(restored[1], name), want),
                       f"restored {name}: not this mesh's ZeRO blocks of the logical ones")
        new = step(*restored, batch)
        soft.check(int(new[2]["skipped"]) == 0 and int(new[1].step) == 3,
                   f"next step: skipped {int(new[2]['skipped'])}, step {int(new[1].step)}")
    soft.done()
    return out


def checks(shape, data: dict, out: Path) -> dict:
    todo = {}
    if shape == (1, 4):
        for key in FOUR:
            for impl in IMPLS:
                todo[f"step/{key}/{impl}"] = (lambda m, key=key, impl=impl:
                                              check_step(m, data[key], key, impl))
        return todo
    for key in MODELS:
        for impl in IMPLS:
            todo[f"step/{key}/{impl}"] = (lambda m, key=key, impl=impl:
                                          check_step(m, data[key], key, impl))
        todo[f"compress/{key}"] = lambda m, key=key: check_compress(m, data[key], key)
        if shape[0] > 1:
            todo[f"zero/{key}"] = lambda m, key=key: check_zero(m, data[key], key)
    if shape[1] > 1:
        for key in ("ssm", "hybrid"):
            todo[f"fault_1b/{key}"] = (lambda m, key=key:
                                       check_fault_distinct(m, data[key], key))
    if shape in ((2, 2), (1, 2)):
        todo["elastic"] = lambda m: check_elastic(m, data[ELASTIC], out)
    return todo


def run(rank: int, world: int, shape: tuple, store: str, cases: str, out_dir: str):
    """One rank: every check on the ``shape`` mesh, results to ``out_dir``."""
    torch.set_num_threads(1)
    f32_activations()
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    out = Path(out_dir)
    try:
        mesh = tmesh.make_conv_mesh(shape, device="cpu")
        with open(cases, "rb") as f:
            data = pickle.load(f)
        results = {}
        for name, check in checks(shape, data, out).items():
            tmesh.reset_collective_bytes()
            try:
                results[name] = ("ok", check(mesh))
            except Exception:  # recorded: the parent reports it per check
                results[name] = ("fail", traceback.format_exc())
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
