"""The ranks of ``tests/test_torch_train_sharding.py``: one process a rank on gloo.

Each rank builds the ``("data", "model")`` mesh and trains the tiny QAT CNN
(``TINY``, the config of ``tests/test_train_faults.py``) and qwen3-32b's
smoke config (2 layers) sharded, holding every step against the port's
one-device step in the same process, and computes the train step's loss
on its block of seeded logits (``api.sharded_lm_loss``) with that block's
gradient; what each check returned (or its traceback) goes to
``rank<r>.pkl``.  No JAX here: the parent handed the
weights and batches over as numpy (``cases.pkl``) and holds the gathered
results against the JAX package.

Tolerances, sharded vs one device (every one a reordered f32 sum):
- the CNN is f32 throughout: a gradient element sums at most ``2^8``
  products (a pixel's patch times the batch), split into two partial sums
  over ``data`` and added, so it moves by at most ``2^8·2^-24·Σ|terms|``;
  with cancellation bounded by the leaf's scale that is ``CNN_TOL = 2^-14``
  of the leaf's max;
- the LM runs bf16 activations: a row-parallel sum over ``model`` adds the
  same f32 partials in another order and rounds once to bf16, so a
  one-ulp (2^-8) flip moves through the layers as it does between the
  ``kernel`` and ``dequant`` impls: ``LM_TOL``, the repo's LM tolerance
  (2.5 % of a leaf's max; ``tests/test_torch_train.py``), and the loss
  within ``LOSS_TOL`` relative.
- Adam's first step moves a weight by ``lr·g/(|g| + eps)``: the new params
  are held (within ``P_TOL``) where ``|mu|`` is at least ``G_FLOOR`` of
  its leaf's max, the moments everywhere (``assert_update_close``'s rule).
A failing comparison is recorded and raised at its check's end, so the
ranks stay in step through the collectives (gloo aborts a rank left in
one).
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

from repro_torch import ft, interop
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.alexnet_conv import CNNConfig
from repro_torch.core import params as tpar
from repro_torch.core.conv import Conv2D, ConvParams
from repro_torch.data.pipeline import DataConfig, synthetic_image_batch
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api, cnn
from repro_torch.models import sharding as tsh
from repro_torch.models.common import ShardCtx, block_of, local_rows
from repro_torch.train import optimizer as opt
from repro_torch.train import step as st
from repro_torch.train.faults import TrainFaultPlan, TrainFaultSpec
from repro_torch.train.loop import run_loop
from repro_torch.tree import flatten_with_path, tree_leaves

COLLECTIVE_TIMEOUT_S = 30  # a rank out of step fails fast instead of hanging
CNN_TOL = 2.0 ** -14
LM_TOL = 2.5e-2
LOSS_TOL = 1e-3
P_TOL = 1e-5
G_FLOOR = 5e-2
CLIP = 1e-3  # binds: every step's norm is far above it

TINY = CNNConfig(
    name="tiny-qat",
    in_chw=(1, 8, 8),
    layers=(Conv2D(k=3, c_in=1, c_out=4, stride=1, relu=True),),
    pools=(2,),
    classes=4,
    bins=4,
)
OCFG = opt.AdamWConfig(lr=1e-2, total_steps=64, warmup_steps=1)
DCFG = DataConfig(seed=0, vocab=2, seq_len=1, global_batch=4)
LM_IMPLS = ("dequant", "kernel")
STEPS, CRASH_AT, CKPT_EVERY = 6, 4, 2


def cnn_batch(step: int) -> dict:
    return synthetic_image_batch(DCFG, step, chw=TINY.in_chw, classes=TINY.classes,
                                 device="cpu")


def lm_config(impl: str):
    """qwen3-32b's smoke config (2 layers, 4/2 heads), its linears weight-
    shared; ``kernel`` also with ``remat`` (the forward's collectives rerun
    in the backward) and the embedding table quantized (a vocab-sharded
    table's codebook)."""
    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl=impl, min_weight_elems=1024, quantize_embed=impl == "kernel")
    return dataclasses.replace(cfg, n_layers=2, remat=impl == "kernel")


def cnn_tree(case: dict) -> dict:
    convs = [ConvParams.dense(torch.from_numpy(k), bias=torch.from_numpy(b))
             for k, b in zip(case["kernels"], case["biases"])]
    return {"params": {"conv": convs, "head": {"w": torch.from_numpy(case["head_w"]),
                                               "b": torch.from_numpy(case["head_b"])}},
            "codebooks": [torch.from_numpy(c) for c in case["codebooks"]]}


def numpy_tree(tree) -> dict:
    return {"/".join(p): x.detach().float().numpy() if x.is_floating_point()
            else x.numpy() for p, x in flatten_with_path(tree)}


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


def same_tree(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def grads_close(soft: Soft, got: dict, want: dict, tol: float, what: str) -> float:
    worst = 0.0
    soft.check(set(got) == set(want), f"{what}: grad leaves {sorted(set(got) ^ set(want))}")
    for k in sorted(set(got) & set(want)):
        worst = max(worst, soft.close(got[k], want[k], tol, f"{what} grad {k}"))
    return worst


def update_close(soft: Soft, got: dict, want: dict, tol: float, what: str, *,
                 params: bool = True) -> None:
    """The moments everywhere (``mu`` within ``tol`` of its leaf's max,
    ``nu = (1 - b2)·g²`` within ``2·tol``: squaring doubles ``g``'s
    relative error), and with ``params`` the new params where the first
    moment is not near zero (``tests/_torch_lm.py::assert_update_close``'s
    rule).  A binding clip scales ``g`` until ``|g|`` nears AdamW's ``eps``,
    where the update is no longer ``±lr``: its params are not compared."""
    for k, w in want.items():
        if k.startswith("0/") and not k.endswith("/idx") and w.dtype.kind == "f":
            if not params:
                continue
            mu = np.abs(want["1/mu/" + k[2:]])
            mask = mu >= G_FLOOR * mu.max(initial=0.0)
            d = np.abs(got[k][mask] - w[mask])
            soft.check(np.all(d <= P_TOL + P_TOL * np.abs(w[mask])),
                       f"{what} new {k}: max |Δ| {d.max(initial=0):.3e}")
        elif k.startswith("1/") and w.ndim:
            soft.close(got[k], w, 2 * tol if k.startswith("1/nu/") else tol, f"{what} {k}")
        else:  # the step counter, the frozen indices
            soft.check(np.array_equal(got[k], w), f"{what} {k} differs")


# ---------------------------------------------------------------------------
# the CNN QAT step
# ---------------------------------------------------------------------------


def check_cnn(mesh, case):
    """One step and its gradients at this mesh against one device; the
    gathered results for the parent's JAX comparison; a binding clip; a
    NaN ``loss_scale`` skipped on every rank with the tree bitwise."""
    soft, out = Soft(), {}
    tree = cnn_tree(case)
    state = (tree, opt.init_opt_state(tree))
    placed = cnn._place(tree, mesh)
    pstate = (placed, opt.init_opt_state(placed))
    specs, sspecs = cnn.qat_specs(TINY, mesh), cnn.qat_specs(TINY, mesh, with_opt=True)
    batch = cnn_batch(0)
    loss1, g1 = st.cnn_loss_and_grads(tree, batch, TINY)
    loss, g = st.cnn_loss_and_grads(placed, batch, TINY, mesh=mesh)
    soft.close(loss, loss1, 1e-6, "loss")
    got = numpy_tree(tsh.gather_params(g, mesh, specs))
    out["grad_err"] = grads_close(soft, got, numpy_tree(g1), CNN_TOL, "cnn")
    out["grads"] = got
    for name, ocfg in (("step", OCFG), ("clip", dataclasses.replace(OCFG, clip_norm=CLIP))):
        one = st.make_cnn_train_step(TINY, ocfg)(*state, batch)
        new = st.make_cnn_train_step(TINY, ocfg, mesh=mesh)(*pstate, batch)
        soft.close(new[2]["grad_norm"], one[2]["grad_norm"], CNN_TOL, f"{name} grad_norm")
        if name == "clip":
            soft.check(float(one[2]["grad_norm"]) > 10 * CLIP, "the clip does not bind")
        gathered = numpy_tree(tsh.gather_params(new[:2], mesh, sspecs))
        update_close(soft, gathered, numpy_tree(one[:2]), CNN_TOL, f"cnn {name}",
                     params=name == "step")
        out[name] = gathered
    poisoned = dict(batch, loss_scale=torch.tensor(float("nan")))
    new = st.make_cnn_train_step(TINY, OCFG, mesh=mesh)(*pstate, poisoned)
    soft.check(int(new[2]["skipped"]) == 1, "NaN step not skipped")
    soft.check(same_tree(new[:2], pstate), "NaN step changed the tree")
    out["bytes"] = dict(tmesh.collective_bytes)
    soft.done()
    return out


def supervised(step_fn, fresh, batches, d: Path, plan, *, mesh=None, specs=None):
    """``run_loop`` under ``ft.Supervisor`` with ``--resume auto``'s restore:
    ``(losses, final state, restarts)``."""
    mgr = ckpt.CheckpointManager(d, mesh=mesh, specs=specs)
    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=2, backoff_s=0.0),
                        sleep=lambda _s: None)
    losses, box = {}, {}

    def loop(resume_step):
        state, start = fresh(), 0
        if ckpt.latest_step(mgr.dir) is not None:
            state, man = mgr.restore_latest(state) if resume_step is None else \
                ckpt.restore(mgr.dir, state, step=resume_step, mesh=mesh, specs=specs)
            start = man["step"]
        res = run_loop(step_fn, state, batches, steps=STEPS, start_step=start, mgr=mgr,
                       ckpt_every=CKPT_EVERY, faults=plan, losses=losses)
        box["state"] = res.state
        return res.last_step

    last = sup.run(loop)
    return last, losses, box["state"], sup.restarts


def check_cnn_resume(mesh, case, out_dir: Path):
    """6 sharded steps with checkpoints every 2, then again with a crash
    after step 4's update on every rank: the restored run's losses and
    final tree bitwise the uninterrupted run's."""
    soft = Soft()
    tag = "x".join(map(str, mesh.shape))
    specs = cnn.qat_specs(TINY, mesh, with_opt=True)
    step_fn = st.make_cnn_train_step(TINY, OCFG, mesh=mesh)

    def fresh():
        placed = cnn._place(cnn_tree(case), mesh)
        return placed, opt.init_opt_state(placed)

    with st.deterministic():
        ref = run_loop(step_fn, fresh(), cnn_batch, steps=STEPS,
                       mgr=ckpt.CheckpointManager(out_dir / f"cnn{tag}_ref", mesh=mesh,
                                                  specs=specs), ckpt_every=CKPT_EVERY)
        plan = TrainFaultPlan([TrainFaultSpec("crash", step=CRASH_AT)])
        last, losses, state, restarts = supervised(
            step_fn, fresh, cnn_batch, out_dir / f"cnn{tag}_run", plan, mesh=mesh,
            specs=specs)
    soft.check(last == STEPS and restarts == 1, f"last {last}, restarts {restarts}")
    soft.check([losses[s] for s in range(STEPS)] == [ref.losses[s] for s in range(STEPS)],
               "losses differ from the uninterrupted run")
    soft.check(same_tree(state, ref.state), "final tree differs from the uninterrupted run")
    soft.check(ref.n_skipped == 0, "a clean step skipped")
    soft.done()
    return {"losses": [ref.losses[s] for s in range(STEPS)]}


# ---------------------------------------------------------------------------
# the LM train step
# ---------------------------------------------------------------------------


def lm_params(case: dict):
    return interop.lm_params_from_numpy(case["params"], device="cpu")


def lm_batch(case: dict, i: int = 0) -> dict:
    x, y = case["batches"][i]
    return {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}


def check_lm(mesh, case, impl: str):
    """One step and its gradients on the placed params under an active
    context against one device; the gathered results for the parent's JAX
    comparison; a binding clip; a NaN ``loss_scale``; two microbatches."""
    soft, out = Soft(), {}
    cfg = lm_config(impl)
    params = lm_params(case)
    placed = tsh.place_params(params, mesh)
    batch = lm_batch(case)
    sctx = ShardCtx.for_mesh(mesh, batch["tokens"].shape[0])
    loss1, _, g1 = st.loss_and_grads(params, batch, cfg)
    tmesh.reset_collective_bytes()
    loss, _, g = st.loss_and_grads(placed, batch, cfg, sctx)
    out["bytes"] = dict(tmesh.collective_bytes)
    soft.close(loss, loss1, LOSS_TOL, "loss")
    got = numpy_tree(tsh.gather_params(g, mesh, tsh.placed_specs(placed, mesh)))
    want = numpy_tree(g1)
    out["grad_err"] = grads_close(soft, got, want, LM_TOL, f"lm {impl}")
    out["grads"], out["loss"] = got, float(loss)
    for name, ocfg in (("step", OCFG), ("clip", dataclasses.replace(OCFG, clip_norm=CLIP))):
        one = st.make_train_step(cfg, ocfg)(params, opt.init_opt_state(params), batch)
        new = st.make_train_step(cfg, ocfg, sctx)(placed, opt.init_opt_state(placed), batch)
        soft.close(new[2]["grad_norm"], one[2]["grad_norm"], LM_TOL, f"{name} grad_norm")
        if name == "clip":
            soft.check(float(one[2]["grad_norm"]) > 10 * CLIP, "the clip does not bind")
        gathered = numpy_tree(tsh.gather_params(new[:2], mesh))
        update_close(soft, gathered, numpy_tree(one[:2]), LM_TOL, f"lm {impl} {name}",
                     params=name == "step")
        out[name] = gathered
    pstate = (placed, opt.init_opt_state(placed))
    poisoned = dict(batch, loss_scale=torch.tensor(float("nan")))
    new = st.make_train_step(cfg, OCFG, sctx)(*pstate, poisoned)
    soft.check(int(new[2]["skipped"]) == 1, "NaN step not skipped")
    soft.check(same_tree(new[:2], pstate), "NaN step changed the tree")
    if impl == "dequant":  # two microbatches of 2 rows: one a data rank each at n_data 2
        _, _, gm1 = st.loss_and_grads(params, batch, cfg, microbatches=2)
        _, _, gm = st.loss_and_grads(placed, batch, cfg, sctx, microbatches=2)
        gm = numpy_tree(tsh.gather_params(gm, mesh, tsh.placed_specs(placed, mesh)))
        grads_close(soft, gm, numpy_tree(gm1), LM_TOL, "microbatches")
    soft.done()
    return out


def check_bias_linear(mesh, case):
    """``tp_linear`` on a column- and a row-parallel leaf with a whole bias
    (the narrowed bias of an N block): the loss's gradients in ``x``, the
    codebooks and the bias, reduced over their axes, against one device."""
    soft = Soft()
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    worst = 0.0
    for name in ("w1", "w2"):  # column-parallel, row-parallel
        w = tpar.PasmParams.shared(
            torch.from_numpy(rng.integers(0, 16, (32, 32)).astype(np.uint8)),
            torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32)),
            bias=torch.from_numpy(rng.standard_normal(32).astype(np.float32))).pack()
        tree = {"x": x, name: w}

        def loss_fn(t, m=None):
            if m is None:
                y = tpar.matmul(t["x"], t[name], impl="kernel")
            else:
                y = tpar.tp_linear(t["x"], t[name], impl="kernel", mesh=m)
                if y.shape[-1] != 32:
                    y = tmesh.all_gather(y, m, "model", dim=-1)
            return (torch.sin(y) * torch.arange(32.0)).sum(), {}

        placed = tsh.place_params(tree, mesh)
        _, _, g1 = st._value_and_grad(loss_fn, tree)
        _, _, g = st._value_and_grad(lambda t: loss_fn(t, mesh), placed)
        axes = tsh.grad_reduce_axes(placed, mesh, batch_split=False)
        # x is replicated (a whole input): its gradient is whole already
        soft.check(axes[("x",)] == (), f"x's axes {axes[('x',)]}")
        g = tsh.reduce_grads(g, axes, mesh)
        got = numpy_tree(tsh.gather_params(g, mesh, tsh.placed_specs(placed, mesh)))
        worst = max(worst, grads_close(soft, got, numpy_tree(g1), 1e-5, name))
    soft.done()
    return {"grad_err": worst}


def check_elastic(mesh, case, out_dir: Path):
    """At (2, 2): 2 sharded steps of the kernel config, checkpointed.  At
    (1, 2): that checkpoint restored onto this mesh (each block bitwise the
    logical arrays'), and the next step's loss and gradients within
    tolerance of one device's from the same checkpoint.  (Its update is not
    compared: past the first step AdamW divides moments of three steps'
    gradients, which the gradients' tolerance does not bound.)"""
    soft, out = Soft(), {}
    cfg = lm_config("kernel")
    d = out_dir.parent / "elastic"
    sctx = ShardCtx.for_mesh(mesh, 4)
    step = st.make_train_step(cfg, OCFG, sctx)
    params = lm_params(case)
    placed = tsh.place_params(params, mesh)
    state = (placed, opt.init_opt_state(placed))
    if mesh.shape == (2, 2):
        mgr = ckpt.CheckpointManager(d, mesh=mesh)
        res = run_loop(step, state, lambda s: lm_batch(case, s), steps=2, mgr=mgr,
                       ckpt_every=2)
        soft.check(ckpt.complete_steps(d) == [2], f"saved {ckpt.complete_steps(d)}")
        out["saved"] = numpy_tree(tsh.gather_params(res.state, mesh))
    else:
        restored, man = ckpt.CheckpointManager(d, mesh=mesh).restore_latest(state)
        one, _ = ckpt.restore(d, (params, opt.init_opt_state(params)))
        soft.check(man["step"] == 2, f"restored step {man['step']}")
        soft.check(same_tree(restored[0], tsh.place_params(one[0], mesh)),
                   "restored params are not this mesh's blocks of the logical ones")
        batch = lm_batch(case, 2)
        loss1, _, g1 = st.loss_and_grads(one[0], batch, cfg)
        loss, _, g = st.loss_and_grads(restored[0], batch, cfg, sctx)
        soft.close(loss, loss1, LOSS_TOL, "next loss")
        got = numpy_tree(tsh.gather_params(g, mesh, tsh.placed_specs(restored[0], mesh)))
        out["grad_err"] = grads_close(soft, got, numpy_tree(g1), LM_TOL, "next step")
        new = step(*restored, batch)
        soft.check(int(new[2]["skipped"]) == 0 and int(new[1].step) == 3,
                   f"next step: skipped {int(new[2]['skipped'])}, step {int(new[1].step)}")
    soft.done()
    return out


def check_loss(mesh, case):
    """``api.sharded_lm_loss`` on this rank's block of each case's global
    logits (its rows over ``data``; its ``V / model`` columns, or every
    column where ``model`` does not divide the vocab: a replicated head)
    with the global labels and mask: the loss, the block's gradient, where
    the block lies, and the bytes the loss's collectives moved.  The parent
    holds them against JAX's ``lm_loss`` on the global logits."""
    out = {}
    for name, c in case.items():
        B, _, V = c["logits"].shape
        cfg = dataclasses.replace(get_config("qwen3-32b", smoke=True), vocab=V)
        sctx = ShardCtx.for_mesh(mesh, B)
        nm = mesh.size("model")
        rows = local_rows(torch.arange(B), sctx)
        cols = block_of(V, V // nm if V % nm == 0 else V, sctx)
        block = torch.from_numpy(c["logits"])[rows][..., cols].clone().requires_grad_()
        mask = None if c["mask"] is None else torch.from_numpy(c["mask"])
        tmesh.reset_collective_bytes()
        loss = api.sharded_lm_loss(block, torch.from_numpy(c["labels"]), mask, cfg, sctx)
        (grad,) = torch.autograd.grad(loss, block)
        out[name] = {"loss": float(loss.detach()), "grad": grad.numpy(), "rows": rows.numpy(),
                     "cols": (cols.start, cols.stop),
                     "bytes": tmesh.collective_bytes["lm_loss"]}
    return out


def checks(shape):
    out = {"cnn": check_cnn, "bias_linear": check_bias_linear, "loss": check_loss}
    for impl in LM_IMPLS:
        out[f"lm_{impl}"] = lambda mesh, case, impl=impl: check_lm(mesh, case, impl)
    return out


def run(rank: int, world: int, shape: tuple, store: str, cases: str, out_dir: str):
    """One rank: every check on the ``shape`` mesh, results to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    out = Path(out_dir)
    try:
        mesh = tmesh.make_conv_mesh(shape, device="cpu")
        with open(cases, "rb") as f:
            data = pickle.load(f)
        todo = dict(checks(shape))
        todo["cnn_resume"] = lambda m, c: check_cnn_resume(m, c, out)
        if shape in ((2, 2), (1, 2)):
            todo["elastic"] = lambda m, c: check_elastic(m, c, out)
        results = {}
        for name, check in todo.items():
            tmesh.reset_collective_bytes()
            case = data["cnn"] if name.startswith("cnn") else data["loss"] \
                if name == "loss" else data["lm"]["dequant" if name == "lm_dequant" else "kernel"]
            try:
                results[name] = ("ok", check(mesh, case))
            except Exception:  # recorded: the parent reports it per check
                results[name] = ("fail", traceback.format_exc())
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
