"""The port's serve stack: scheduler, fault plan, Engine, MixedBatcher.

The scheduler and the fault plan are pure Python and must equal the JAX
package's exactly.  The Engine is held to the JAX package's invariants
inside the port (continuous admission equals the solo run token for token,
quarantine and retry keep unaffected requests bit-identical), to the JAX
Engine's token streams on the same weights, and to the port's narrowed
degradation: only an injected kernel fault degrades; a real exception
propagates.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_lm import port_params
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import faults as jfaults
from repro.serve import scheduler as jsched
from repro.serve.engine import Engine as JEngine
from repro_torch.configs import get_cnn_config, get_config
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import cnn, transformer as TT
from repro_torch.models.common import quantize_params
from repro_torch.serve import faults as tfaults
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.batcher import CnnBatcher, MixedBatcher
from repro_torch.serve.engine import Engine
from repro_torch.tree import tree_leaves


@functools.lru_cache(maxsize=None)
def _setup(arch="stablelm-3b"):
    cfg = get_config(arch, smoke=True)
    return cfg, tapi.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))


def _solo_out(cfg, params, prompt, max_new, *, slots=3, max_seq=48):
    eng = Engine(cfg, params, batch_slots=slots, max_seq=max_seq)
    r = eng.submit(prompt, max_new=max_new)
    eng.run_until_drained()
    return r.out


# ---------------------------------------------------------------------------
# scheduler and fault plan: exact against the JAX package
# ---------------------------------------------------------------------------


class _Req:
    def __init__(self, uid, n, max_new=4, deadline=None):
        self.uid, self.prompt, self.max_new, self.deadline = uid, [0] * n, max_new, deadline


def _drive(mod, policy):
    """A scripted run of one scheduler; returns everything it decided."""
    s = mod.Scheduler(2, bucket_fn=lambda n: mod.pow2_bucket(n, hi=32), max_seq=32,
                      max_queue=2, policy=policy)
    log = []
    reqs = [_Req(1, 5), _Req(2, 9, deadline=1.0), _Req(3, 3), _Req(4, 17, deadline=9.0)]
    for r in reqs:
        try:
            log.append(("shed", [x.uid for x in s.submit(r, now=2.0)]))
        except mod.QueueFullError as e:
            log.append(("full", [x.uid for x in e.shed]))
    plans = s.admit()
    log.append([(p.req.uid, p.slot, p.bucket) for p in plans])
    s.quarantine(plans[0].slot)
    log.append((s.free_slots, s.live_slots, s.queue_depth))
    s.release(plans[0].slot)
    s.requeue(_Req(5, 30, max_new=3))
    log.append([(p.req.uid, p.slot, p.bucket) for p in s.admit()])
    log.append([x.uid for x in s.shed_expired(100.0)])
    for bad in (_Req(6, 33), _Req(7, 30, max_new=4)):
        with pytest.raises(ValueError):
            s.validate(bad)
    return log


@pytest.mark.parametrize("policy", ["reject", "shed_oldest", "shed_expired"])
def test_scheduler_matches_jax(policy):
    assert _drive(tsched, policy) == _drive(jsched, policy)
    for n in (0, 1, 7, 8, 9, 100, 1000):
        assert tsched.pow2_bucket(n) == jsched.pow2_bucket(n)
        assert tsched.pow2_bucket(n, hi=64) == jsched.pow2_bucket(n, hi=64)
        assert tsched.exact_bucket(n, hi=50) == jsched.exact_bucket(n, hi=50)
    with pytest.raises(ValueError, match="policy"):
        tsched.Scheduler(2, policy="lifo")


def test_fault_plan_matches_jax():
    kw = dict(n_ticks=30, n_slots=4, n_requests=8, n_nan=3, n_prefill=2,
              n_decode=2, n_slow=1, slow_delay_s=5.0, n_kernel=1)
    for seed in (0, 7, 8):
        a = tfaults.FaultPlan.sample(seed, **kw)
        b = jfaults.FaultPlan.sample(seed, **kw)
        assert [dataclasses.asdict(f) for f in a.faults] == \
            [dataclasses.asdict(f) for f in b.faults]
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    specs = [("nan", dict(tick=3, slot=1)), ("decode", dict(tick=5)),
             ("prefill", dict(uid=2, nth=1)), ("slow", dict(tick=4, delay_s=2.5)),
             ("kernel", dict(key="decode"))]
    plans = [m.FaultPlan([m.FaultSpec(k, **f) for k, f in specs]) for m in (tfaults, jfaults)]
    for plan, mod in zip(plans, (tfaults, jfaults)):
        assert plan.poison_slots(3) == [1] and plan.on_tick(4) == 2.5
        with pytest.raises(mod.FaultInjected):
            plan.on_decode(5)
        with pytest.raises(mod.FaultInjected):
            plan.on_prefill(2, 1)
        plan.on_prefill(2, 6)
        assert plan.kernel_broken("decode") and not plan.kernel_broken("prefill:8")
    assert plans[0].fired == plans[1].fired
    with pytest.raises(ValueError, match="kind"):
        tfaults.FaultSpec("meteor")


# ---------------------------------------------------------------------------
# the Engine
# ---------------------------------------------------------------------------


def test_continuous_admission_equals_solo():
    """With slots mid-decode, a newly admitted request's output equals its
    solo (batch-of-one prefill) run, token for token; a short prompt beside
    longer ones and a reused slot too."""
    cfg, params = _setup()
    rng = np.random.default_rng(3)
    probe = rng.integers(0, cfg.vocab, size=5)
    want = _solo_out(cfg, params, probe, 8)
    eng = Engine(cfg, params, batch_slots=3, max_seq=48)
    others = [eng.submit(rng.integers(0, cfg.vocab, size=int(n)), max_new=12)
              for n in (4, 9)]
    for _ in range(3):
        eng.step()
    assert all(not o.done for o in others)
    r = eng.submit(probe, max_new=8)
    eng.run_until_drained()
    assert r.out == want and all(o.done for o in others)
    assert eng.calls["prefill"] == 3 and eng.calls["decode"] == eng.tick
    # slot reuse never leaks the previous occupant's KV
    one = Engine(cfg, params, batch_slots=1, max_seq=48)
    first = one.submit(rng.integers(0, cfg.vocab, size=6), max_new=6)
    second = one.submit(probe, max_new=8)
    one.run_until_drained()
    assert second.slot == first.slot and second.out == want


def test_engine_tokens_match_jax_engine():
    """The same weights and traffic through both engines: the first tokens
    agree, and the streams agree on ≥ 90 % of their tokens (bf16 logits
    round at other places in the two frameworks, so a near-tie can flip a
    greedy token, after which a stream runs on other inputs)."""
    jc = jget("stablelm-3b", smoke=True)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    cfg = get_config("stablelm-3b", smoke=True)
    params = port_params(jparams)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in (5, 9, 3, 12)]
    outs = []
    for eng in (JEngine(jc, jparams, batch_slots=2, max_seq=48),
                Engine(cfg, params, batch_slots=2, max_seq=48)):
        reqs = [eng.submit(p, max_new=6) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([r.out for r in reqs])
    jo, to = outs
    assert [o[0] for o in to] == [o[0] for o in jo]
    agree = np.mean([a == b for x, y in zip(to, jo) for a, b in zip(x, y)])
    assert agree >= 0.9, (to, jo)


def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``|x|`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "internvl2-26b"])
def test_moe_and_vlm_engine_tokens_match_jax_engine(arch):
    """The MoE family (a dense leading layer: a non-empty ``caches["dense"]``
    grafted slot by slot; dropless routing at prefill and decode) and the
    VLM served text-only, as the JAX ``Engine`` serves it: the same weights
    and traffic through both engines give the same token streams, each up
    to its first difference.  There both engines have read the same tokens,
    and the two candidates must be a greedy near-tie: their logits, from a
    prefill of that common prefix in each package, lie within one bf16 ulp
    of each other (past it the stream runs on other inputs)."""
    jc = jget(arch, smoke=True)
    jparams = jax.jit(lambda k: JT.init_params(jc, k))(jax.random.PRNGKey(0))
    cfg = get_config(arch, smoke=True)
    params = port_params(jparams)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in (5, 9, 3, 12)]
    outs = []
    for eng in (JEngine(jc, jparams, batch_slots=2, max_seq=48),
                Engine(cfg, params, batch_slots=2, max_seq=48)):
        reqs = [eng.submit(p, max_new=6) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([r.out for r in reqs])
    assert len(eng.caches["dense"]) == (cfg.moe.first_dense_layers if cfg.moe else 0)
    to, jo = outs[1], outs[0]
    assert [len(o) for o in to] == [len(o) for o in jo] == [6] * len(prompts)
    for prompt, t, j in zip(prompts, to, jo):
        diff = [i for i, (a, b) in enumerate(zip(t, j)) if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(j[:i])]).astype(np.int32)[None]
        jl, _ = JT.prefill(jparams, jnp.asarray(seq), JT.init_caches(jc, 1, 48), jc)
        tl, _ = TT.prefill(params, torch.from_numpy(seq),
                           TT.init_caches(cfg, 1, 48, device="cpu"), cfg)
        for lg in (np.asarray(jl.astype(jnp.float32))[0, -1], tl.float().numpy()[0, -1]):
            a, b = float(lg[t[i]]), float(lg[j[i]])
            assert abs(a - b) <= _bf16_ulp(max(abs(a), abs(b))), (i, t, j, a, b)
    assert tlaunch.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "2",
                         "--max-new", "2", "--max-seq", "32"]) == 0


def test_encdec_engine_tokens_match_jax_engine():
    """whisper-tiny served as the JAX ``Engine`` serves it (every request
    encoded from silence, the cross K/V grafted slot by slot with the self
    cache), its layers weight-shared on ``kernel`` (K1's plain version)
    against the JAX engine on ``dequant``: the same token streams, each up
    to its first difference, where the two candidates must be a greedy
    near-tie in both packages (within one bf16 ulp, from a prefill of the
    common prefix); and the launcher serves it on the CPU."""
    from repro.models import common as jcommon
    from repro.models import encdec as JE
    from repro_torch.models import encdec as TE

    q = dict(enabled=True, min_weight_elems=1024)
    jc = jget("whisper-tiny", smoke=True).with_quant(impl="dequant", **q)
    jparams = jax.jit(lambda k: jcommon.quantize_params(JE.init_params(jc, k), jc))(
        jax.random.PRNGKey(0))
    cfg = get_config("whisper-tiny", smoke=True).with_quant(impl="kernel", **q)
    params = port_params(jparams)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)) for n in (5, 9, 3, 12)]
    outs = []
    for eng in (JEngine(jc, jparams, batch_slots=2, max_seq=48),
                Engine(cfg, params, batch_slots=2, max_seq=48)):
        reqs = [eng.submit(p, max_new=6) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([r.out for r in reqs])
    jo, to = outs
    assert [len(o) for o in to] == [len(o) for o in jo] == [6] * len(prompts)
    assert eng.calls["prefill"] == len(prompts)
    # the batched cache: per layer the cross K/V of every slot, filled
    assert len(eng.caches) == cfg.n_layers
    assert eng.caches[0]["cross"]["k"].shape == (2, cfg.frontend_tokens, cfg.n_kv_heads,
                                                 cfg.hd)
    assert all(bool(c["cross"]["k"].abs().amax(dim=(1, 2, 3)).gt(0).all())
               for c in eng.caches)
    for prompt, t, j in zip(prompts, to, jo):
        diff = [i for i, (a, b) in enumerate(zip(t, j)) if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(j[:i])]).astype(np.int32)[None]
        jl, _ = jax.jit(lambda p, s, c: JE.prefill(p, s, c, jc))(
            jparams, jnp.asarray(seq), JE.init_caches(jc, 1, 48))
        tl, _ = TE.prefill(params, torch.from_numpy(seq),
                           TE.init_caches(cfg, 1, 48, device="cpu"), cfg)
        for lg in (np.asarray(jl.astype(jnp.float32))[0, -1], tl.float().numpy()[0, -1]):
            a, b = float(lg[t[i]]), float(lg[j[i]])
            assert abs(a - b) <= _bf16_ulp(max(abs(a), abs(b))), (i, t, j, a, b)
    assert tlaunch.main(["--arch", "whisper-tiny", "--smoke", "--device", "cpu",
                         "--requests", "2", "--max-new", "2", "--max-seq", "32"]) == 0


def _quantized(impl="kernel"):
    cfg, params = _setup()
    qcfg = cfg.with_quant(enabled=True, bins=16, impl=impl, min_weight_elems=1024)
    return qcfg, quantize_params(params, qcfg)


def test_injected_kernel_fault_degrades_and_counts():
    qcfg, qparams = _quantized()
    rng = np.random.default_rng(71)
    p = rng.integers(0, qcfg.vocab, size=5)
    ref = Engine(qcfg, qparams, batch_slots=2, max_seq=48)
    want = ref.submit(p, max_new=5)
    ref.run_until_drained()
    assert ref._degraded == set()
    plan = tfaults.FaultPlan([tfaults.FaultSpec("kernel", key="decode")])
    eng = Engine(qcfg, qparams, batch_slots=2, max_seq=48, faults=plan)
    with pytest.warns(RuntimeWarning, match="degrading"):
        r = eng.submit(p, max_new=5)
        eng.run_until_drained()
    assert eng._degraded == {"decode"}
    assert eng.metrics.rollup()["n_degraded"] == 1
    assert r.done and r.out == want.out  # dequant is K1's oracle
    r2 = eng.submit(rng.integers(0, qcfg.vocab, size=4), max_new=4)
    eng.run_until_drained()
    assert r2.done and eng.metrics.rollup()["n_degraded"] == 1


def test_real_kernel_exception_propagates(monkeypatch):
    """Unlike the JAX engine, a real failure in a kernel is never served
    around on the dequant path: it propagates and nothing is degraded."""
    from repro_torch.kernels import ops

    qcfg, qparams = _quantized()

    def broken(*a, **k):
        raise RuntimeError("pasm_matmul kernel launch failed: cudaError 7")

    monkeypatch.setattr(ops, "pasm_matmul", broken)
    eng = Engine(qcfg, qparams, batch_slots=2, max_seq=48)
    eng.submit(np.arange(5), max_new=3)
    with pytest.raises(RuntimeError, match="cudaError 7"):
        eng.step()
    assert eng._degraded == set() and eng.metrics.rollup()["n_degraded"] == 0
    # with nothing to degrade to, an injected kernel fault surfaces as well
    cfg, params = _setup()
    plan = tfaults.FaultPlan([tfaults.FaultSpec("kernel", key="decode")])
    dense = Engine(cfg, params, batch_slots=1, max_seq=48, faults=plan)
    dense.submit(np.arange(4), max_new=4)
    with pytest.raises(RuntimeError, match="injected persistent kernel"):
        dense.run_until_drained()


def test_chaos_unaffected_requests_bit_identical():
    """NaN-poisoned slot (quarantine, scrub, retry), a failed prefill
    (retry) and a transient decode fault: every request finishes, and each
    output equals the fault-free run's."""
    cfg, params = _setup()
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 7, 4, 6)]

    def run(plan):
        eng = Engine(cfg, params, batch_slots=2, max_seq=48, faults=plan, max_retries=2)
        reqs = [eng.submit(p, max_new=5) for p in prompts]
        eng.run_until_drained()
        return eng, reqs

    _, clean = run(None)
    plan = tfaults.FaultPlan([tfaults.FaultSpec("nan", tick=3, slot=0),
                              tfaults.FaultSpec("prefill", uid=3, nth=1),
                              tfaults.FaultSpec("decode", tick=4)])
    eng, hit = run(plan)
    roll = eng.metrics.rollup()
    assert all(r.done for r in hit)
    assert [r.out for r in hit] == [r.out for r in clean]
    assert roll["n_quarantined"] == 1 and roll["n_retried"] == 2
    assert roll["n_faults_decode"] == 1 and not eng.sched.quarantined


@pytest.mark.parametrize("arch", ["stablelm-3b", "whisper-tiny"])
def test_chaos_terminal_faults_leave_others_bit_identical(arch):
    """DESIGN.md §2.4, the JAX package's chaos invariant for the padded
    families: with no retries a NaN-poisoned slot fails ``numeric`` with
    its partial output kept, a failed first prefill fails ``error`` with
    none, a transient decode fault replays its tick, the engine drains, and
    every unaffected request equals the fault-free run's bit for bit."""
    cfg, params = _setup(arch)
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab, size=n) for n in (5, 7, 4, 6)]
    ref = Engine(cfg, params, batch_slots=3, max_seq=48)
    ref_reqs = [ref.submit(p, max_new=8) for p in prompts]
    ref.run_until_drained()
    assert all(r.done for r in ref_reqs)
    plan = tfaults.FaultPlan([tfaults.FaultSpec("nan", tick=3, slot=1),
                              tfaults.FaultSpec("prefill", uid=4, nth=1),
                              tfaults.FaultSpec("decode", tick=2)])
    eng = Engine(cfg, params, batch_slots=3, max_seq=48, faults=plan, max_retries=0)
    reqs = [eng.submit(p, max_new=8) for p in prompts]
    eng.run_until_drained()
    roll = eng.metrics.rollup()
    assert roll["n_stuck"] == 0
    r_nan, r_err = reqs[1], reqs[3]
    assert r_nan.status == "failed:numeric" and 0 < len(r_nan.out) < 8
    assert r_err.status == "failed:error" and r_err.out == []
    assert roll["n_quarantined"] == 1 and roll["failed_numeric_n"] == 1
    assert roll["failed_error_n"] == 1 and roll["n_faults_decode"] == 1
    for got, want in ((reqs[0], ref_reqs[0]), (reqs[2], ref_reqs[2])):
        assert got.done and got.out == want.out


@pytest.mark.parametrize("arch", ["stablelm-3b", "whisper-tiny"])
def test_quarantine_then_reuse_never_leaks_kv(arch):
    """DESIGN.md §2.4: a slot whose occupant was NaN-poisoned is scrubbed
    from the fresh template (the self cache and, for the encdec family, the
    cross K/V) before reuse, and its next occupant equals a solo run bit
    for bit."""
    cfg, params = _setup(arch)
    rng = np.random.default_rng(37)
    victim_p = rng.integers(0, cfg.vocab, size=6)
    probe_p = rng.integers(0, cfg.vocab, size=5)
    want = _solo_out(cfg, params, probe_p, 6, slots=1)
    plan = tfaults.FaultPlan([tfaults.FaultSpec("nan", tick=2, slot=0)])
    eng = Engine(cfg, params, batch_slots=1, max_seq=48, faults=plan, max_retries=0)
    victim = eng.submit(victim_p, max_new=6)
    eng.step()  # tick 1: admit the victim
    eng.step()  # tick 2: decode, poisoned, quarantined
    assert victim.status == "failed:numeric"
    assert eng.sched.quarantined == {0} and eng.sched.free_slots == []
    eng._scrub_quarantined()  # what the next tick's admission does first
    fresh = tapi.get_model(cfg).init_caches(cfg, 1, 48, device="cpu")
    assert all(torch.equal(got, tmpl)  # the whole slot is the template again
               for got, tmpl in zip(tree_leaves(eng.caches), tree_leaves(fresh)))
    probe = eng.submit(probe_p, max_new=6)
    eng.run_until_drained()
    assert eng.sched.quarantined == set()
    assert probe.done and probe.slot == 0 and probe.out == want


def test_mixed_batcher_and_launcher_on_cpu(capsys):
    cfg, params = _setup()
    ccfg = get_cnn_config("alexnet", smoke=True)
    cparams = cnn.quantize(cnn.init_params(ccfg, torch.Generator().manual_seed(0),
                                           device="cpu"), ccfg)
    eng = Engine(cfg, params, batch_slots=2, max_seq=32)
    cb = CnnBatcher(ccfg, cparams, max_batch=2, metrics=eng.metrics, device="cpu")
    lm = [eng.submit(np.arange(n) % cfg.vocab, max_new=3) for n in (3, 5, 4)]
    C, H, W = ccfg.in_chw
    imgs = [cb.submit(np.ones((C, h, h), np.float32)) for h in (8, H)]
    ticks = MixedBatcher(eng, cb).run_until_drained()
    assert ticks >= 1 and all(r.done for r in lm) and all(r.done for r in imgs)
    assert eng.metrics.rollup()["n_done"] == 5
    assert tlaunch.main(["--arch", "qwen3-32b", "--smoke", "--device", "cpu",
                         "--requests", "3", "--max-new", "3", "--max-seq", "32"]) == 0
    out = capsys.readouterr().out
    assert "3/3 done" in out and "PASM weights" in out
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(np.arange(30), max_new=8)
