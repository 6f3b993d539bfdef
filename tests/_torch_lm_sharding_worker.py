"""The ranks of ``tests/test_torch_lm_sharding.py``: one process a rank on gloo.

Each rank builds the mesh, places the LM params and caches
(``models/sharding.py::place_params``/``place_caches``) and runs every
check on the CPU; what each check returned (or its traceback) goes to
``rank<r>.pkl``.  A check holds the sharded calls against the port's
single-device calls in the same process and returns the sharded logits,
which the parent holds against the JAX package.  No JAX here: the parent
handed the JAX weights and the inputs over as numpy (``cases.pkl``).

What is bitwise and what is held to a tolerance (``transformer.py``'s
docstring): with no ``model`` split and no MoE reduction the sharded
logits are bitwise one device's (one thread a rank: MKL's threaded sgemm
splits K by the shape); a row-parallel sum or an MoE sum over ``data`` or
``model`` adds the same f32 terms in another order, so the logits are held
within ``LOGIT_TOL`` of max |logit| on the sequences no routing flip
reaches, and every flip must be a near-tie (``TIE``).  A failing check is
recorded, not raised, so the ranks stay in step through the collectives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import pickle
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import mesh as tmesh
from repro_torch.models import sharding as tsh
from repro_torch.models import transformer as TT
from repro_torch.models.common import ShardCtx
from repro_torch.nn import moe as TM

COLLECTIVE_TIMEOUT_S = 30  # a rank out of step fails fast instead of hanging
LOGIT_TOL = 0.025  # of max |logit|, as tests/test_torch_transformer.py
TIE = 2.0 ** -5  # a routing near-tie: within 2^-5 of the k-th probability
# (impl, kv_bits): every impl with the bf16 cache, K1 with the int8 one
COMBOS = (("dequant", 16), ("kernel", 16), ("kernel", 8), ("pas_kernel", 16))
# the MoE call above the regime switch: |Δ| <= MOE_TOL·max|y| (the sums of
# the shared w2 and the combine over model in another order, in f32)
MOE_TOL = 2.0 ** -7


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def smoke_config(arch: str, **quant):
    return tconfigs.get_config(arch, smoke=True).with_quant(
        enabled=True, min_weight_elems=1024, **quant)


@contextlib.contextmanager
def routes(log: list):
    """Record each MoE call's router input (``x`` f32, router) in order."""
    inner = TM.route

    def spy(x, router, k):
        log.append((x.float(), router))
        return inner(x, router, k)

    TM.route = spy
    try:
        yield log
    finally:
        TM.route = inner


def run_calls(params, cfg, sctx, case, caches) -> tuple:
    """forward, prefill (right-padded) and the decode steps; the logits and
    each call's routing log."""
    toks, lengths, fe = _t(case["toks"]), _t(case["lengths"]), case["fe"]
    fe = None if fe is None else _t(fe).bfloat16()
    logs = {"fwd": [], "pre": [], "dec": []}
    out = {}
    with routes(logs["fwd"]):
        out["fwd"], out["aux"] = TT.forward(params, toks, cfg, sctx, frontend_embeds=fe)
    with routes(logs["pre"]):
        out["pre"], caches = TT.prefill(params, toks, caches, cfg, sctx,
                                        lengths=lengths, frontend_embeds=fe)
    out["dec"] = []
    for step in case["nxt"]:
        with routes(logs["dec"]):
            logit, caches = TT.decode_step(params, _t(step), caches, cfg, sctx)
        out["dec"].append(logit)
    out["pos"] = [c.pos.tolist() for c in caches["dense"] + caches["scan"]]
    return out, logs


def flipped(one: list, mine: list, k: int, row0: int, seq: int) -> set:
    """The sequences a routing flip reaches: the rows (from ``row0`` of the
    one-device call's) where this rank's chosen experts differ from the
    one-device call's, each a near-tie in the one-device probabilities."""
    seqs = set()
    for (xo, r), (xm, _) in zip(one, mine):
        po, _, io = TM.route(xo, r, k)
        _, _, im = TM.route(xm, r, k)
        io = io[row0:row0 + xm.shape[0]].sort(-1).values
        im = im.sort(-1).values
        po = po[row0:row0 + xm.shape[0]]
        for t in torch.nonzero((io != im).any(-1)).flatten().tolist():
            kth = po[t].sort().values[-k]
            extra = set(im[t].tolist()) - set(io[t].tolist())
            assert all(po[t, e] >= kth * (1 - TIE) for e in extra), \
                f"row {row0 + t}: a flip that is not a near-tie"
            seqs.add((row0 + t) // seq)
    return seqs


def _same(got, want, what: str) -> None:
    if got.shape != want.shape or not torch.equal(got, want):
        d = (got.float() - want.float()).abs().max() if got.shape == want.shape else None
        raise AssertionError(f"{what}: sharded != single device (shape "
                             f"{tuple(got.shape)} vs {tuple(want.shape)}, max |Δ| {d})")


def _close(got, want, rows, what: str) -> None:
    assert got.shape == want.shape, (what, got.shape, want.shape)
    g, w = got.float(), want.float()
    scale = w.abs().max()
    if rows:
        d = (g[rows] - w[rows]).abs().max()
        assert d <= LOGIT_TOL * scale, f"{what}: max |Δ| {float(d)} > {LOGIT_TOL}·{float(scale)}"


@contextlib.contextmanager
def soft(errors: list, what: str):
    """Record a failed comparison and go on: every rank must make every
    collective of the check, so a check raises only at its end."""
    try:
        yield
    except AssertionError as e:
        errors.append(f"{what}: {e}")


def check_lm(mesh, case):
    """The three transformer families at smoke size: forward, prefill and
    3 decode steps on every impl and both caches, held against one device."""
    out, errors = {}, []
    nd, nm = tmesh.data_model_sizes(mesh)
    for arch, c in case.items():
        tc = smoke_config(arch)
        params = interop.lm_params_from_numpy(c["params"], device="cpu")
        placed = tsh.place_params(params, mesh)
        B, S = c["toks"].shape
        sctx = ShardCtx.for_mesh(mesh, B)
        moe = bool(tc.moe and tc.moe.n_experts)
        bitwise = nm == 1 and not moe
        k = tc.moe.top_k if moe else 1  # k > 1: the routing is compared
        b0 = mesh.index("data") * B // nd if sctx.batch_split else 0
        rows0 = lambda n: b0 * n // B if sctx.batch_split else 0  # noqa: E731
        res = {}
        for impl, kv in COMBOS:
            cfg = tc.with_quant(impl=impl, kv_bits=kv)
            what = f"{arch}/{impl}/kv{kv}"
            # one device with the mesh's dispatch groups (JAX's dp): the
            # same capacity per group, so the same drops
            want, wlog = run_calls(params, cfg, ShardCtx(dp=sctx.dp), c,
                                   TT.init_caches(cfg, B, c["max_seq"], device="cpu"))
            caches = tsh.place_caches(cfg, TT.init_caches(cfg, B, c["max_seq"], device="cpu"),
                                      mesh, sctx.batch)
            got, glog = run_calls(placed, cfg, sctx, c, caches)
            with soft(errors, what):
                res[impl, kv, "flipped"] = compare(
                    got, want, glog, wlog, bitwise=bitwise, k=k, rows0=rows0, B=B,
                    S_p=S + (c["fe"].shape[1] if c["fe"] is not None else 0),
                    dp=sctx.dp, own=range(b0, b0 + B // sctx.dp), what=what)
            res[impl, kv] = {"fwd": got["fwd"].float().numpy(),
                             "pre": got["pre"].float().numpy(),
                             "dec": [d.float().numpy() for d in got["dec"]],
                             "pos": got["pos"]}
            if moe and impl == "dequant":
                res[impl, kv]["routes"] = {
                    key: [x.numpy() for x, _ in glog[key]] for key in glog}
        out[arch] = res
    if errors:
        raise AssertionError("\n".join(errors))
    return out


def compare(got, want, glog, wlog, *, bitwise: bool, k: int, rows0, B: int,
            S_p: int, dp: int, own: range, what: str) -> list:
    """One impl's sharded calls against one device's (module docstring) on
    this rank's ``own`` batch rows, whose routing it saw (every rank returns
    the same global logits: the parent holds them equal); returns the
    batch rows a routing flip reached."""
    assert got["pos"] == want["pos"], (got["pos"], want["pos"])
    if bitwise:
        _same(got["fwd"], want["fwd"], what + " forward")
        _same(got["pre"], want["pre"], what + " prefill")
        for i, (g, w) in enumerate(zip(got["dec"], want["dec"])):
            _same(g, w, f"{what} decode {i}")
        return []
    moe = k > 1
    # forward routes under a capacity: a flip moves later tokens' queue
    # places, so a flip leaves no row of its group compared
    S_f = got["fwd"].shape[1]
    per = B * S_f // dp
    hit = flipped(wlog["fwd"], glog["fwd"], k, rows0(B * S_f), per) if moe else set()
    _close(got["fwd"].reshape(B * S_f, -1), want["fwd"].reshape(B * S_f, -1),
           [r for r in range(B * S_f) if r // S_f in own and r // per not in hit],
           what + " forward")
    hit = flipped(wlog["pre"], glog["pre"], k, rows0(B * S_p), S_p) if moe else set()
    _close(got["pre"][:, 0], want["pre"][:, 0], [b for b in own if b not in hit],
           what + " prefill")
    n_layers = len(wlog["dec"]) // len(want["dec"]) if moe else 0
    for i, (g, w) in enumerate(zip(got["dec"], want["dec"])):
        if moe:
            sl = slice(i * n_layers, (i + 1) * n_layers)
            hit |= flipped(wlog["dec"][sl], glog["dec"][sl], k, rows0(B), 1)
        _close(g[:, 0], w[:, 0], [b for b in own if b not in hit], f"{what} decode {i}")
    if moe:
        np.testing.assert_allclose(float(got["aux"]["moe_load_balance"]),
                                   float(want["aux"]["moe_load_balance"]), rtol=1e-2)
    return sorted(hit)


def check_moe_above_switch(mesh, case):
    """One MoE call of more than 4096 tokens (the weight-gather regime) and
    one below it, on every impl: ``moe_ffn(mesh=)`` on this rank's group
    against the one-device call on the same tokens.  The routing is the
    same bitwise (the router is whole and each row's product its own)."""
    tc = smoke_config("deepseek-moe-16b")
    nd, _ = tmesh.data_model_sizes(mesh)
    lp = interop.lm_params_from_numpy(case["params"], device="cpu")["layers"][0]["moe"]
    placed = tsh.place_params({"layers": [{"moe": lp}]}, mesh)["layers"][0]["moe"]
    out, errors = {}, []
    for T, x in (("big", case["x_big"]), ("small", case["x_small"])):
        x = _t(x).bfloat16()
        rows = x.shape[0] // nd
        mine = x[mesh.index("data") * rows:(mesh.index("data") + 1) * rows] if nd > 1 else x
        for impl in ("dequant", "kernel", "pas_kernel"):
            # two dispatch groups on every mesh: a rank's own at n_data 2
            want, waux = TM.moe_ffn(x, lp, tc.moe, impl=impl, n_groups=2)
            got, gaux = TM.moe_ffn(mine, placed, tc.moe, impl=impl, n_groups=2, mesh=mesh,
                                   group_spec=("data",) if nd > 1 else None)
            w = want[mesh.index("data") * rows:][:rows] if nd > 1 else want
            with soft(errors, f"{T}/{impl}"):
                d = (got.float() - w.float()).abs().max()
                assert d <= MOE_TOL * want.float().abs().max(), \
                    f"max |Δ| {float(d)} vs max |y| {float(want.abs().max())}"
                for key in waux:
                    np.testing.assert_allclose(float(gaux[key]), float(waux[key]),
                                               rtol=1e-5, atol=1e-6, err_msg=key)
            out[T, impl] = got.float().numpy()
    if errors:
        raise AssertionError("\n".join(errors))
    return out


CHECKS = {"lm": check_lm, "moe_above_switch": check_moe_above_switch}


def run(rank: int, world: int, shape: tuple, store: str, cases: str, out_dir: str):
    """One rank: every check on the ``shape`` mesh, results to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = tmesh.make_conv_mesh(shape, device="cpu")
        with open(cases, "rb") as f:
            data = pickle.load(f)
        results = {}
        for name, check in CHECKS.items():
            tmesh.reset_collective_bytes()
            try:
                results[name] = ("ok", check(mesh, data.get(name)),
                                 dict(tmesh.collective_bytes))
            except Exception:  # recorded: the parent reports it per check
                results[name] = ("fail", traceback.format_exc(), {})
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
