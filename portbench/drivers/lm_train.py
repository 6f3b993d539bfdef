"""LM training through the port's ``train/step.py::make_train_step``.

Set-up builds one train step with its model and AdamW state from the seed
and drives it through its first ``check_steps`` steps, each through the
same call the window makes, on batches of rows that all differ: they are
the warm-up, and what the check reads.  It keeps each of their losses, the
optimizer's first moments after step 1 (the clipped gradient the optimizer
took, times ``1 − b1``) and the trained leaves before and after them.  The
window then runs the same step on further batches until ``--seconds`` have
passed, each step waited for.  The check runs the reference's steps from
the same drawn leaves on the same batches and compares, by the worst
leaf, the gap between the program's norm and the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time

import torch

from portbench.drivers import lm_serve
from portbench.reference import draw
from portbench.reference import lm_train as ref_train

__all__ = ["setup", "window", "free", "check", "control", "batch", "compare"]


def batch(run, i: int) -> dict:
    """Batch ``i`` of the seed's stream: ``rows × seq`` tokens and their
    next-token labels, drawn on the device."""
    mix, cfg = run.mix, run.cfg
    g = draw.generator(run.seed, f"batch{i}", run.device)
    t = torch.randint(0, cfg["vocab"], (mix["rows"], mix["seq"] + 1), generator=g,
                      device=run.device, dtype=torch.int64)
    return {"tokens": t[:, :-1].to(torch.int32), "labels": t[:, 1:].to(torch.int32)}


def _flat(params: dict) -> dict:
    """The trained leaves of the port's tree, by the reference's names."""
    out = {"embed": params["embed"]}
    for i, lp in enumerate(params["layers"]):
        out[f"layer{i}.attn_norm"] = lp["attn_norm"]
        out[f"layer{i}.ffn_norm"] = lp["ffn_norm"]
        for m in ("wq", "wk", "wv", "wo"):
            out[f"layer{i}.{m}"] = lp["attn"][m].codebook
        for m in ("w1", "w3", "w2"):
            out[f"layer{i}.{m}"] = lp["mlp"][m].codebook
    out["final_norm"] = params["final_norm"]
    out["lm_head"] = params["lm_head"].codebook
    return out


def _host(tree: dict) -> dict:
    return {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in tree.items()}


def setup(run) -> None:
    if run.cuda:
        from repro_torch.kernels import _build

        _build.build()
    from repro_torch.train import optimizer as opt
    from repro_torch.train.step import make_train_step

    cfg, mix = run.cfg, run.mix
    pcfg = dataclasses.replace(lm_serve.port_config(cfg), remat=bool(mix["remat"]))
    params = lm_serve.port_params(cfg, run.seed, run.device, embed_dtype=torch.float32)
    o = mix["adamw"]
    ocfg = opt.AdamWConfig(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                           weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                           warmup_steps=o["warmup_steps"], total_steps=o["total_steps"],
                           min_lr_frac=o["min_lr_frac"])
    step = make_train_step(pcfg, ocfg)
    state = opt.init_opt_state(params)
    before = _host(_flat(params))
    losses = []
    for i in range(mix["check_steps"]):
        params, state, met = step(params, state, batch(run, i))
        losses.append(float(met["loss"]))
        if i == 0:
            mu1 = _host(_flat(state.mu))
    after = _host(_flat(params))
    run.state.update(step=step, params=params, opt=state, losses=losses,
                     grad1={k: v / (1 - o["b1"]) for k, v in mu1.items()},
                     delta={k: after[k] - before[k] for k in before})


def window(run) -> None:
    from repro_torch.kernels.pasm_matmul import launches

    st, mix = run.state, run.mix
    step = st["step"]
    n, i = 0, mix["check_steps"]
    run.start_window()
    while True:
        b = batch(run, i)
        k1 = launches.get("pasm_matmul", 0)
        with run.spans.span("train_step", sync=True) as a:
            st["params"], st["opt"], met = step(st["params"], st["opt"], b)
            ok = math.isfinite(float(met["loss"]))
            a["k1"] = launches.get("pasm_matmul", 0) - k1
        now = time.perf_counter()
        n += 1
        i += 1
        run.failed += 0 if ok else 1
        if now >= run.t0 + run.seconds:
            break
        run.profile_tick(now)
    run.t1 = now
    run.attempted = n
    run.counters = {"steps": n, "tokens": n * mix["rows"] * mix["seq"]}


def free(run) -> None:
    for k in ("step", "params", "opt"):
        run.state.pop(k, None)


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def compare(got: dict, want: dict, floor_of: dict = None) -> tuple:
    """The worst leaf's gap between two norms, over the larger of the
    reference's norm of that leaf and of the median leaf: ``(gap, leaf)``.
    Leaves whose reference gradient (``floor_of``) is under a thousandth of
    the median leaf's are left out: they move by round-off alone."""
    g, w = _norms(got), _norms(want)
    med = sorted(w.values())[len(w) // 2]
    keep = w
    if floor_of is not None:
        f = _norms(floor_of)
        fmed = sorted(f.values())[len(f) // 2]
        keep = {k: v for k, v in w.items() if f[k] >= 1e-3 * fmed}
    worst = max(keep, key=lambda k: abs(g[k] - w[k]) / max(w[k], med))
    return abs(g[worst] - w[worst]) / max(w[worst], med), worst


def _reference(run, rnd=None, rows=None) -> dict:
    bs = []
    for i in range(run.mix["check_steps"]):
        b = batch(run, i)
        r = slice(None) if rows is None else slice(0, rows)
        bs.append((b["tokens"][r], b["labels"][r]))
    return ref_train.train_steps(run.cfg, run.seed, bs, run.mix["adamw"], run.device, rnd)


def _readings(st: dict, ref: dict, log=None) -> dict:
    loss = max(abs(a - b) / abs(b) for a, b in zip(st["losses"], ref["loss"]))
    g, gl = compare(st["grad1"], {k: v.cpu() for k, v in ref["grad1"].items()})
    d, dl = compare(st["delta"], {k: v.cpu() for k, v in ref["delta"].items()},
                    {k: v.cpu() for k, v in ref["grad1"].items()})
    if log is not None:
        log(f"losses {st['losses']} against {ref['loss']}; worst gradient leaf {gl}, "
            f"worst change leaf {dl}")
    return {"loss_err": loss, "grad_err": g, "delta_err": d}


def check(run) -> dict:
    """The numbers ``run.limits`` holds (``grad_err``, ``delta_err``); the
    loss's gap is logged, not compared: no control or fault separates it
    from sound runs (PERF.md)."""
    ref = _reference(run)
    log = lambda m: print(f"[portbench] check: {m}", file=sys.stderr, flush=True)  # noqa: E731
    r = _readings(run.state, ref, log)
    log(f"loss_err {r['loss_err']!r} (not compared)")
    out = {k: {"value": r[k], "limit": run.limits[k]} for k in run.limits}
    out["failed_steps"] = {"value": run.failed, "limit": 0}
    return out


def _in_place(low: dict) -> dict:
    """Reference steps put in the program's place, as the check reads it."""
    return {"losses": low["loss"], "grad1": {k: v.cpu() for k, v in low["grad1"].items()},
            "delta": {k: v.cpu() for k, v in low["delta"].items()}}


def control(run, rounding) -> dict:
    """The control's readings: the reference at ``rounding`` put in the
    program's place, read against the reference as the check reads the
    program."""
    return _readings(_in_place(_reference(run, rounding)), _reference(run))


def half_batch(run) -> dict:
    """A planted fault's readings: the reference's steps on half of each
    batch's rows (the mean over the rest) in the program's place."""
    return _readings(_in_place(_reference(run, rows=run.mix["rows"] // 2)), _reference(run))
