"""The port's training chaos suite: ``tests/test_train_faults.py``'s
invariants inside ``repro_torch``, on the CPU.

Seeded, step-keyed faults (:class:`repro_torch.train.faults.TrainFaultPlan`)
drive the crash-safe loop (:func:`repro_torch.train.loop.run_loop`), and the
two DESIGN.md §4.2 invariants hold **bitwise** (``torch.equal``) under
``train.step.deterministic()``:

* a resumed run after a crash equals the uninterrupted run, losses and
  final params and optimizer state;
* a poisoned step (NaN loss / overflow spike) leaves params and optimizer
  state bit-identical.

Also: the supervisor's classification, fallback past corrupt checkpoints,
escalation, and ``TrainFaultPlan.sample(seed)`` equal to the JAX
package's.  The sharded case of the JAX suite waits for ROADMAP Queue 1
item 10.
"""
from __future__ import annotations

import warnings

import pytest
import torch

from repro.train.faults import TrainFaultPlan as JaxTrainFaultPlan
from repro_torch import ft
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.configs.alexnet_conv import CNNConfig
from repro_torch.core.conv import Conv2D
from repro_torch.data.pipeline import DataConfig, retry_io, synthetic_image_batch
from repro_torch.models import cnn
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod
from repro_torch.train.faults import SimulatedCrash, TrainFaultPlan, TrainFaultSpec
from repro_torch.train.loop import NonFiniteEscalation, run_loop
from repro_torch.tree import tree_leaves

# tiny QAT stack: one conv layer, 8×8 images — the real STE path
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


def batch_fn(step: int) -> dict:
    return synthetic_image_batch(DCFG, step, chw=TINY.in_chw, classes=TINY.classes,
                                 device="cpu")


def fresh_state():
    params = cnn.init_params(TINY, torch.Generator().manual_seed(0), device="cpu")
    tree = {"params": params, "codebooks": cnn.qat_codebooks(params, TINY)}
    return tree, opt.init_opt_state(tree)


@pytest.fixture(autouse=True)
def _deterministic():
    with step_mod.deterministic():
        yield


@pytest.fixture(scope="module")
def tiny_step():
    return step_mod.make_cnn_train_step(TINY, OCFG)


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.ndim else x, y.view(torch.uint8)
                           if y.ndim else y)


# ---------------------------------------------------------------------------
# the fused guard: skip is bit-identical, escalation after K
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("poison", ["nan", "spike"])
def test_guard_skips_poisoned_step_bit_identical(tiny_step, poison):
    tree, opt_state = fresh_state()
    scale = float("nan") if poison == "nan" else TrainFaultSpec("grad_spike").scale
    batch = dict(batch_fn(0), loss_scale=torch.tensor(scale))
    new_tree, new_opt, metrics = tiny_step(tree, opt_state, batch)
    assert int(metrics["skipped"]) == 1
    assert not torch.isfinite(metrics["loss"])
    assert_trees_equal(new_tree, tree)
    assert_trees_equal(new_opt, opt_state)
    assert int(new_opt.step) == int(opt_state.step)


def test_clean_step_updates_and_reports_not_skipped(tiny_step):
    tree, opt_state = fresh_state()
    new_tree, new_opt, metrics = tiny_step(tree, opt_state, batch_fn(0))
    assert int(metrics["skipped"]) == 0 and torch.isfinite(metrics["loss"])
    assert int(new_opt.step) == 1
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(tree),
                                                     tree_leaves(new_tree)))
    # functional: the old state is untouched, and a rerun is bitwise the same
    again = tiny_step(tree, opt_state, batch_fn(0))
    assert_trees_equal(again[:2], (new_tree, new_opt))


def test_guard_off_applies_poisoned_update():
    step_fn = step_mod.make_cnn_train_step(TINY, OCFG, guard_nonfinite=False)
    tree, opt_state = fresh_state()
    batch = dict(batch_fn(0), loss_scale=torch.tensor(float("nan")))
    new_tree, _, metrics = step_fn(tree, opt_state, batch)
    assert int(metrics["skipped"]) == 0
    assert any(torch.isnan(x).any() for x in tree_leaves(new_tree["params"]))


def test_lm_train_step_guard_skips_nan():
    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params

    params = quantize_params(TT.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    opt_state = opt.init_opt_state(params)
    step_fn = step_mod.make_train_step(cfg, OCFG)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "loss_scale": torch.tensor(float("nan"))}
    new_p, new_s, metrics = step_fn(params, opt_state, batch)
    assert int(metrics["skipped"]) == 1
    assert_trees_equal(new_p, params)
    assert_trees_equal(new_s, opt_state)


def test_escalates_after_k_consecutive_nonfinite(tiny_step):
    plan = TrainFaultPlan([TrainFaultSpec("nan_loss", step=s) for s in (2, 3, 4)])
    with pytest.raises(NonFiniteEscalation) as ei:
        run_loop(tiny_step, fresh_state(), batch_fn, steps=10, faults=plan,
                 max_consecutive_nonfinite=3)
    assert ei.value.step == 4 and ei.value.n_consecutive == 3
    assert isinstance(ei.value, ft.RestorableError)


def test_nonconsecutive_skips_do_not_escalate(tiny_step):
    plan = TrainFaultPlan([TrainFaultSpec("nan_loss", step=s) for s in (1, 3, 5)])
    res = run_loop(tiny_step, fresh_state(), batch_fn, steps=7, faults=plan,
                   max_consecutive_nonfinite=3)
    assert res.n_skipped == 3 and res.last_step == 7


def test_poisoned_step_loop_level_bit_identity(tiny_step):
    """N steps with the last poisoned ≡ N-1 clean steps, bit for bit."""
    n = 5
    clean = run_loop(tiny_step, fresh_state(), batch_fn, steps=n - 1)
    plan = TrainFaultPlan([TrainFaultSpec("nan_loss", step=n - 1)])
    poisoned = run_loop(tiny_step, fresh_state(), batch_fn, steps=n, faults=plan)
    assert poisoned.n_skipped == 1
    assert poisoned.losses[n - 1] != poisoned.losses[n - 1]  # NaN
    assert_trees_equal(poisoned.state, clean.state)


# ---------------------------------------------------------------------------
# crash + restore: bit-exact resume under the supervisor
# ---------------------------------------------------------------------------


def _supervised_run(step_fn, plan, tmp, *, steps, ckpt_every, max_restarts=3):
    """The launcher's loop shape in miniature; returns merged history."""
    mgr = ckpt.CheckpointManager(tmp, keep=3)
    losses: dict = {}
    times: dict = {}
    box = {"state": fresh_state(), "resumed_at": []}
    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=max_restarts, backoff_s=0.0),
                        sleep=lambda _d: None)

    def loop(resume_step):
        t, o = box["state"]
        start = 0
        if ckpt.latest_step(mgr.dir) is not None:
            (t, o), man = mgr.restore_latest((t, o))
            start = man["step"]
            box["resumed_at"].append(start)
        res = run_loop(step_fn, (t, o), batch_fn, steps=steps, start_step=start,
                       mgr=mgr, ckpt_every=ckpt_every, faults=plan,
                       losses=losses, step_times=times)
        box["state"] = res.state
        return res.last_step

    last = sup.run(loop)
    return last, box, losses, sup, mgr


@pytest.mark.parametrize("seed", [1, 7])
def test_resume_after_crash_bit_exact(tiny_step, tmp_path, seed):
    steps = 8
    ref = run_loop(tiny_step, fresh_state(), batch_fn, steps=steps)
    plan = TrainFaultPlan.sample(seed, n_steps=steps, n_nan=0, n_spike=0,
                                 n_ckpt_io=0, n_data_io=0, n_crash=1)
    assert plan.trajectory_preserving
    last, box, losses, sup, _ = _supervised_run(tiny_step, plan, tmp_path, steps=steps,
                                                ckpt_every=2)
    assert last == steps and sup.restarts == 1
    assert [f[0] for f in plan.fired] == ["crash"]
    assert [losses[s] for s in range(steps)] == [ref.losses[s] for s in range(steps)]
    assert_trees_equal(box["state"], ref.state)


def test_resume_restores_older_checkpoint_and_recomputes(tiny_step, tmp_path):
    plan = TrainFaultPlan([TrainFaultSpec("crash", step=5)])
    last, box, _, _, _ = _supervised_run(tiny_step, plan, tmp_path, steps=8,
                                         ckpt_every=2)
    assert last == 8 and box["resumed_at"] == [4]


def test_sampled_chaos_plan_completes_under_supervisor(tiny_step, tmp_path):
    plan = TrainFaultPlan.sample(3, n_steps=10, n_slow=1, slow_delay_s=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        last, _, losses, _, _ = _supervised_run(tiny_step, plan, tmp_path, steps=10,
                                                ckpt_every=2)
    assert last == 10
    assert {"crash", "data_io", "slow"} <= {f[0] for f in plan.fired}
    assert set(losses) == set(range(10))


# ---------------------------------------------------------------------------
# checkpoint integrity: CRC detection, fallback
# ---------------------------------------------------------------------------


def _flip_byte(path, offset_frac=0.5):
    raw = bytearray(path.read_bytes())
    raw[int(len(raw) * offset_frac)] ^= 0xFF
    path.write_bytes(bytes(raw))


def _w(shift=0.0):
    return {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8) + shift}


def test_crc_verify_detects_byte_flip(tmp_path):
    ckpt.save(tmp_path, 1, _w())
    _flip_byte(tmp_path / "step_1" / "shard_0.npz")
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(tmp_path, _w(), step=1)


@pytest.mark.parametrize("corruption", ["byte_flip", "truncate"])
def test_fallback_to_newest_valid_checkpoint(tmp_path, corruption):
    ckpt.save(tmp_path, 1, _w(1))
    ckpt.save(tmp_path, 2, _w(2))
    shard = tmp_path / "step_2" / "shard_0.npz"
    if corruption == "byte_flip":
        _flip_byte(shard)
    else:
        shard.write_bytes(shard.read_bytes()[: len(shard.read_bytes()) // 2])
    with pytest.warns(RuntimeWarning, match="failed integrity"):
        restored, man = ckpt.restore(tmp_path, _w(), fallback=True)
    assert man["step"] == 1 and torch.equal(restored["w"], _w(1)["w"])
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.restore(tmp_path, _w())


def test_fallback_past_several_and_all_corrupt(tmp_path):
    for s in (1, 2, 3):
        ckpt.save(tmp_path, s, _w(s))
    for s in (3, 2):
        _flip_byte(tmp_path / f"step_{s}" / "shard_0.npz")
    with pytest.warns(RuntimeWarning):
        _, man = ckpt.restore(tmp_path, _w(), fallback=True)
    assert man["step"] == 1
    _flip_byte(tmp_path / "step_1" / "shard_0.npz")
    with pytest.warns(RuntimeWarning):
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.restore(tmp_path, _w(), fallback=True)


def test_manager_restore_latest_falls_back(tmp_path):
    mgr = ckpt.CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _w())
    mgr.save(2, _w(5))
    mgr.wait()
    _flip_byte(tmp_path / "step_2" / "shard_0.npz")
    with pytest.warns(RuntimeWarning):
        _, man = mgr.restore_latest(_w())
    assert man["step"] == 1


def test_ckpt_io_fault_warns_counts_and_training_continues(tiny_step, tmp_path):
    plan = TrainFaultPlan([TrainFaultSpec("ckpt_io", step=2)])
    with pytest.warns(RuntimeWarning, match="checkpoint save"):
        res = run_loop(tiny_step, fresh_state(), batch_fn, steps=6, faults=plan,
                       mgr=ckpt.CheckpointManager(tmp_path, keep=3), ckpt_every=2)
    assert res.last_step == 6 and res.n_ckpt_failures == 1
    assert ckpt.complete_steps(tmp_path) == [4, 6]


# ---------------------------------------------------------------------------
# data faults, slow faults, the supervisor's classification
# ---------------------------------------------------------------------------


def test_data_io_fault_absorbed_or_exhausts_retries(tiny_step):
    plan = TrainFaultPlan([TrainFaultSpec("data_io", step=1)])
    with pytest.warns(RuntimeWarning, match="transient I/O"):
        res = run_loop(tiny_step, fresh_state(), batch_fn, steps=3, faults=plan,
                       io_sleep=lambda _d: None)
    assert res.last_step == 3 and plan.fired == [("data_io", 1, 1)]
    plan = TrainFaultPlan([TrainFaultSpec("data_io", step=1, nth=n) for n in range(1, 6)])
    with pytest.warns(RuntimeWarning):
        with pytest.raises(OSError):
            run_loop(tiny_step, fresh_state(), batch_fn, steps=3, faults=plan,
                     data_retries=2, io_sleep=lambda _d: None)


def test_retry_io_backoff_schedule_capped():
    delays, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 5:
            raise OSError("flake")
        return "ok"

    with pytest.warns(RuntimeWarning):
        assert retry_io(flaky, retries=4, backoff_s=0.1, cap_s=0.25,
                        sleep=delays.append) == "ok"
    assert delays == [0.1, 0.2, 0.25, 0.25]


def test_slow_fault_inflates_recorded_step_time_every_step(tiny_step):
    plan = TrainFaultPlan([TrainFaultSpec("slow", step=2, delay_s=100.0)])
    det = ft.StragglerDetector(n_hosts=1, window=8)
    res = run_loop(tiny_step, fresh_state(), batch_fn, steps=4, faults=plan, detector=det)
    assert res.step_times[2] > 100.0
    assert len(det._times[0]) == 4


def test_supervisor_deterministic_same_step_fails_fast():
    calls = {"n": 0}

    def loop(resume_step):
        calls["n"] += 1
        raise SimulatedCrash(7)

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=5, backoff_s=0.0),
                        sleep=lambda _d: None)
    with pytest.raises(ft.DeterministicFailure):
        sup.run(loop)
    assert calls["n"] == 2
    assert sup.classified[-1] == (("SimulatedCrash", 7), "deterministic")


def test_supervisor_transient_steps_restart_and_thread_resume_step():
    calls = {"n": 0}

    def loop(resume_step):
        calls["n"] += 1
        if calls["n"] <= 3:
            raise SimulatedCrash(calls["n"])  # another step each time
        return 42

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=5, backoff_s=0.0),
                        sleep=lambda _d: None)
    assert sup.run(loop) == 42 and sup.restarts == 3
    seen = []

    def loop2(resume_step):
        seen.append(resume_step)
        if len(seen) == 1:
            raise NonFiniteEscalation(9, 3, resume_step=6)
        return 10

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=2, backoff_s=0.0),
                        sleep=lambda _d: None)
    assert sup.run(loop2) == 10 and seen == [None, 6]
    assert ft.failure_signature(ft.StepFailure(3, ValueError("x"))) == ("ValueError", 3)


def test_escalation_repeating_at_same_step_is_deterministic():
    def loop(resume_step):
        raise NonFiniteEscalation(9, 3, resume_step=6)

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=5, backoff_s=0.0),
                        sleep=lambda _d: None)
    with pytest.raises(ft.DeterministicFailure):
        sup.run(loop)
    assert sup.restarts == 1


# ---------------------------------------------------------------------------
# plan determinism, equal to the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 3, 11])
def test_fault_plan_sample_equals_jax(seed):
    kw = dict(n_steps=50, n_slow=2, slow_delay_s=1.0)
    a = TrainFaultPlan.sample(seed, **kw)
    j = JaxTrainFaultPlan.sample(seed, **kw)
    assert [vars(f) for f in a.faults] == [vars(f) for f in j.faults]
    assert a.faults == TrainFaultPlan.sample(seed, **kw).faults
    assert a.faults != TrainFaultPlan.sample(seed + 1, **kw).faults
    assert all(1 <= f.step < 50 for f in a.faults)


def test_fault_plan_rejects_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        TrainFaultSpec("segfault", step=1)
