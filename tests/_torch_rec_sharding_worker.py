"""The ranks of ``tests/test_torch_rec_sharding.py``: one process a rank on gloo.

Each rank builds the mesh, places the params and caches
(``models/sharding.py::place_params``/``place_caches``) of mamba2-130m,
recurrentgemma-2b, whisper-tiny (also a one-head variant whose heads
``model`` cuts), phi3-medium-14b and qwen3-32b with 6 q heads over 3 KV
heads at smoke size (at (1, 4): qwen3-32b's smoke and the 6-head variant),
runs forward, a prefill
and decode steps on every impl under an active ``ShardCtx``, and holds
each call against the port's single-device calls in its own process: the
logits within ``tol`` of max |logit| (bitwise where the mesh has no
``model`` split: every product a row block of one device's), the caches
gathered back (``gather_caches``) within the same tolerance of one
device's, their counters exactly.  What each check returned (or its traceback) goes to
``rank<r>.pkl``; the parent holds the ``dequant`` logits against the JAX
package's unsharded calls.  No JAX here: the parent hands the JAX weights
and the inputs over as numpy.  A failing comparison is recorded and raised
at the check's end (``soft``), so the ranks stay in step through the
collectives.
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
from _torch_heads import attended

from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import mesh as tmesh
from repro_torch.models import api
from repro_torch.models import sharding as tsh
from repro_torch.models.common import ShardCtx, head_block
from repro_torch.tree import flatten_with_path

COLLECTIVE_TIMEOUT_S = 30  # a rank out of step fails fast instead of hanging
LOGIT_TOL = 0.025  # of max |logit|, as tests/test_torch_transformer.py
HYBRID_TOL = 0.08  # the RG-LRU gates amplify bf16 noise (tests/test_torch_hybrid.py)
# qwen3's smoke with 6 q heads over 3 KV heads: at ``model`` 2 each rank's 3
# q heads straddle a KV group
STRADDLE = "qwen3-32b/6-3"
ARCHS = ("mamba2-130m", "recurrentgemma-2b", "whisper-tiny", "phi3-medium-14b", STRADDLE)
# the archs the (1, 4) mesh runs: qwen3's smoke (2 KV heads, one q head a
# rank) and the straddling variant (two ranks a block of 3 q heads)
FOUR = ("qwen3-32b", STRADDLE)
# whisper with one head of 64 (the smoke width): ``model`` 2 cuts its heads, so
# q, k and v are gathered and its self and cross caches split their positions
CUT = "whisper-tiny/1-head"
VARIANTS = {CUT: ("whisper-tiny", {"n_heads": 1, "n_kv_heads": 1, "head_dim": 64}),
            STRADDLE: ("qwen3-32b", {"n_heads": 6, "n_kv_heads": 3})}
SEEDED = (CUT,)  # the variants on the port's own weights (the rest: JAX's)
# (impl, kv_bits): every impl; phi3's int8 KV cache on K1 too
COMBOS = {a: (("dequant", 16), ("kernel", 16), ("pas_kernel", 16))
          for a in ARCHS + FOUR + (CUT,)}
COMBOS["phi3-medium-14b"] += (("kernel", 8),)
# the families that take right-padded prompts (the recurrent scans do not)
PADDED = ("whisper-tiny", "phi3-medium-14b", "qwen3-32b")


def padded(arch: str) -> bool:
    return VARIANTS.get(arch, (arch,))[0] in PADDED


def tol(arch: str) -> float:
    return HYBRID_TOL if arch == "recurrentgemma-2b" else LOGIT_TOL


def smoke_config(arch: str, **quant):
    base, changes = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(tconfigs.get_config(base, smoke=True), **changes).with_quant(
        enabled=True, min_weight_elems=1024, **quant)


def variant_params(arch: str):
    """A variant's weights, seeded and quantized by the port (every rank
    draws the same): its one-device calls are the reference."""
    from repro_torch.models import encdec as TE
    from repro_torch.models.common import quantize_params

    cfg = smoke_config(arch)
    p = api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(3))
    return TE.quantize_frontend(quantize_params(p, cfg, iters=2), bins=16, iters=2)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def run_calls(params, cfg, sctx, arch: str, c: dict, S_cache: int) -> tuple:
    """forward, prefill and the decode steps (and the hybrid's prompt past
    its ring with its own steps): each call's logits and the caches after
    the last step of each prompt."""
    m = api.get_model(cfg)
    mesh = sctx.mesh if sctx.active else None
    toks, mel = _t(c["toks"]), _t(c["mel"])
    kw = {} if mel is None else {"frontend_embeds": mel}
    out = {"fwd": m.forward(params, toks, cfg, sctx, **kw)[0]}
    runs = [("pre", "dec", toks, c["nxt"])]
    if c.get("long") is not None:
        runs.append(("long", "long_dec", _t(c["long"]), c["long_nxt"]))
    caches = {}
    for pre, dec, t, nxt in runs:
        cache = m.init_caches(cfg, t.shape[0], S_cache, device="cpu")
        like = cache
        if mesh is not None:
            cache = tsh.place_caches(cfg, cache, mesh, sctx.batch)
        lengths = _t(c["lengths"]) if padded(arch) and pre == "pre" else None
        pkw = dict(kw) if lengths is None else dict(kw, lengths=lengths)
        out[pre], cache = m.prefill(params, t, cache, cfg, sctx, **pkw)
        out[dec] = []
        for step in nxt:
            logit, cache = m.decode_step(params, _t(step), cache, cfg, sctx)
            out[dec].append(logit)
        if mesh is not None:
            cache = tsh.gather_caches(cfg, cache, mesh, sctx.batch, like)
        caches[pre] = cache
    return out, caches


def _max_rel(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)


@contextlib.contextmanager
def soft(errors: list, what: str):
    """Record a failed comparison and go on: every rank must make every
    collective of the check, so a check raises only at its end."""
    try:
        yield
    except AssertionError as e:
        errors.append(f"{what}: {e}")


def compare(got, want, exact: bool, limit: float, what: str) -> float:
    """Logits: bitwise when ``exact``, else within ``limit`` of max |logit|;
    returns the error (0 when bitwise)."""
    assert got.shape == want.shape, (what, tuple(got.shape), tuple(want.shape))
    assert bool(torch.isfinite(got).all()), what
    if torch.equal(got, want):
        return 0.0
    e = _max_rel(got, want)
    assert not exact, f"{what}: not bitwise one device's ({e:.3e} of max)"
    assert e <= limit, f"{what}: {e:.4f} of max |logit| over {limit}"
    return e


def compare_caches(got, want, limit: float, what: str) -> None:
    """Gathered caches vs one device's: integer leaves (counters, ring
    positions) exactly, float leaves within ``limit`` of the leaf's max
    (the layers' inputs carry the logits' reordering)."""
    g, w = flatten_with_path(got), flatten_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w], what
    for (path, a), (_, b) in zip(g, w):
        name = f"{what} cache {'/'.join(path)}"
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not a.is_floating_point():
            assert torch.equal(a, b), name
        elif not torch.equal(a, b):
            e = _max_rel(a, b)
            assert e <= limit, f"{name}: {e:.4f} of its max over {limit}"


def check_families(mesh, cases):
    """Every model at smoke size on every impl, held against one device
    (module docstring): bitwise with no ``model`` split, else within
    ``tol`` (a row-parallel sum adds its f32 partials in another order);
    returns the sharded logits and errors, and under ``"heads"`` each
    arch's head block (``(q0, nq)``) and the ``(q heads, KV heads)`` its
    attention calls ran on."""
    out, errors = {"heads": {}}, []
    shape = tmesh.data_model_sizes(mesh)
    for arch, c in cases.items():
        tc = smoke_config(arch)
        params = variant_params(arch) if arch in SEEDED else \
            interop.lm_params_from_numpy(c["params"], device="cpu")
        placed = tsh.place_params(params, mesh)
        B = c["toks"].shape[0]
        sctx = ShardCtx.for_mesh(mesh, B)
        hb = head_block(tc, sctx)
        res, seen = {}, set()
        for impl, kv in COMBOS[arch]:
            cfg = tc.with_quant(impl=impl, kv_bits=kv)
            what = f"{arch}/{impl}/kv{kv}"
            want, wcache = run_calls(params, cfg, ShardCtx(), arch, c, c["max_seq"])
            with attended() as calls:
                got, gcache = run_calls(placed, cfg, sctx, arch, c, c["max_seq"])
            seen.update(calls)
            errs = {}
            with soft(errors, what):
                for key, w in want.items():
                    ws = w if isinstance(w, list) else [w]
                    gs = got[key] if isinstance(w, list) else [got[key]]
                    errs[key] = max(compare(g, v, shape[1] == 1, tol(arch),
                                            f"{what} {key} {i}")
                                    for i, (g, v) in enumerate(zip(gs, ws)))
                for key in wcache:
                    compare_caches(gcache[key], wcache[key], tol(arch), f"{what} {key}")
            res[impl, kv] = {k: ([t.float().numpy() for t in v] if isinstance(v, list)
                                 else v.float().numpy()) for k, v in got.items()}
            res[impl, kv]["errs"] = errs
        out[arch] = res
        out["heads"][arch] = ((hb.q0, hb.nq), sorted(seen))
    if errors:
        raise AssertionError("\n".join(errors))
    return out


CHECKS = {"families": check_families}


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
                results[name] = ("ok", check(mesh, data), dict(tmesh.collective_bytes))
            except Exception:  # recorded: the parent reports it per check
                results[name] = ("fail", traceback.format_exc(), {})
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
