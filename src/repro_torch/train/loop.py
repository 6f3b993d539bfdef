"""The crash-safe training loop (DESIGN.md §4).

Port of ``repro.train.loop``: ``run_loop`` is the step engine shared by
``repro_torch.launch.train`` (the CLI), the chaos suite
(tests/test_torch_train_faults.py) and ``chip_smoke.py``.  Per step it:

1. fetches the step-addressed batch (``batch_fn(step)``) through the capped
   -backoff I/O retry (:func:`repro_torch.data.pipeline.retry_io`) — a
   transient ``data_io`` fault costs a retry, not the run;
2. applies the fault plan's ``loss_scale`` (NaN / spike poisoning rides the
   batch into the train step — the model code never sees the plan);
3. runs the guarded train step: a non-finite loss/grad SKIPS the update
   bit-exactly (``metrics["skipped"]``), and ``K`` consecutive skips
   escalate to :class:`NonFiniteEscalation` — a
   :class:`repro_torch.ft.RestorableError` carrying the step and the
   newest checkpoint hint, so the supervisor restores-and-retries once and
   fails fast (``ft.DeterministicFailure``) if the same step escalates
   again;
4. records the step time with the straggler detector EVERY step (virtual
   ``slow`` stalls included — zero wall clock in tests);
5. fires the plan's ``crash`` hook (after the update, before the step's
   checkpoint — the worst-case kill point for resume);
6. checkpoints every ``ckpt_every`` steps through the integrity-checked
   manager; an injected/real ``OSError`` at save time warns and counts
   (``n_ckpt_failures``) instead of killing training — the next interval
   retries, and restore falls back past any torn write.

The loss/step-time trajectories are written into the caller's ``history``
dicts keyed by step, so a supervised (crash + restore) run accumulates one
coherent trajectory across attempts, bitwise equal to the uninterrupted
run's (step-addressed data, a deterministic step).

Sharded, every rank runs the loop in step with the same step-addressed
batches and the same fault plan, so a crash fires on every rank at the
same step; a ``CheckpointManager(mesh=)`` gathers the logical arrays, rank
0 writes them, and its ``wait`` is the barrier every rank passes before a
restore reads them back.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Optional

import torch

from repro_torch import ft
from repro_torch.data.pipeline import retry_io

__all__ = ["NonFiniteEscalation", "LoopResult", "run_loop"]


class NonFiniteEscalation(ft.RestorableError):
    """K consecutive non-finite steps: the guard stopped skipping and
    escalated.  Restorable — a transient numeric storm (flaky interconnect,
    a bad HBM read) clears after restore; a deterministic one (poisoned
    data) repeats at the same ``step`` and the supervisor then fails fast."""

    def __init__(self, step: int, n_consecutive: int, resume_step: Optional[int]):
        super().__init__(
            f"{n_consecutive} consecutive non-finite steps ending at step "
            f"{step}: escalating for restore"
        )
        self.step = step
        self.n_consecutive = n_consecutive
        self.resume_step = resume_step


@dataclasses.dataclass
class LoopResult:
    """What one (possibly resumed) loop attempt produced."""

    last_step: int
    state: Any  # (params, opt_state) after the final executed step
    losses: dict  # step -> float loss (NaN on guarded-skip steps)
    step_times: dict  # step -> seconds (virtual slow stalls included)
    n_skipped: int = 0
    n_ckpt_failures: int = 0


def run_loop(
    train_step: Callable,
    state: tuple,
    batch_fn: Callable[[int], dict],
    *,
    steps: int,
    start_step: int = 0,
    mgr=None,
    ckpt_every: int = 0,
    ckpt_extra: Optional[dict] = None,
    faults=None,
    detector: Optional[ft.StragglerDetector] = None,
    host: int = 0,
    max_consecutive_nonfinite: int = 3,
    data_retries: int = 3,
    data_backoff_s: float = 0.0,
    io_sleep: Callable[[float], None] = time.sleep,
    time_fn: Callable[[], float] = time.perf_counter,
    log_every: int = 0,
    log_fn: Callable[[str], None] = print,
    losses: Optional[dict] = None,
    step_times: Optional[dict] = None,
) -> LoopResult:
    """Run ``train_step`` from ``start_step`` to ``steps`` crash-safely.

    ``state`` is ``(params, opt_state)`` (any tree pair
    ``train_step(params, opt_state, batch)`` accepts).  ``losses`` /
    ``step_times`` are optional caller-owned dicts accumulated across
    supervisor restarts.  Checkpoints save at steps ``s+1`` divisible by
    ``ckpt_every`` plus a final save at ``steps``.
    """
    params, opt_state = state
    losses = {} if losses is None else losses
    step_times = {} if step_times is None else step_times
    n_skipped = n_ckpt_failures = 0
    skip_streak = 0
    last_saved: Optional[int] = start_step if start_step else None

    def _save(at_step: int) -> None:
        nonlocal n_ckpt_failures, last_saved
        try:
            if faults is not None:
                faults.on_ckpt_save(at_step)
            mgr.save(at_step, (params, opt_state), extra=ckpt_extra)
            last_saved = at_step
        except OSError as e:
            n_ckpt_failures += 1
            warnings.warn(
                f"checkpoint save at step {at_step} failed ({e}); training "
                f"continues — the next interval retries and restore falls "
                f"back past torn writes",
                RuntimeWarning,
                stacklevel=2,
            )

    for s in range(start_step, steps):
        t0 = time_fn()
        if faults is not None:
            # the fault hook rides the retried fetch: nth-keyed data_io
            # faults are absorbed exactly like a real transient OSError
            batch = retry_io(
                lambda: (faults.on_data(s), batch_fn(s))[1],
                retries=data_retries, backoff_s=data_backoff_s, sleep=io_sleep,
            )
            scale = faults.loss_scale(s)
            if scale is not None:
                dev = next(iter(batch.values())).device
                batch = dict(batch, loss_scale=torch.tensor(
                    scale, dtype=torch.float32, device=dev))
        else:
            batch = retry_io(
                lambda: batch_fn(s),
                retries=data_retries, backoff_s=data_backoff_s, sleep=io_sleep,
            )

        params, opt_state, metrics = train_step(params, opt_state, batch)
        loss = float(metrics["loss"])  # blocks: the step is done on the device
        skipped = bool(int(metrics.get("skipped", 0)))

        dt = time_fn() - t0
        if faults is not None:
            dt += faults.slow_delay(s)
        if detector is not None:
            detector.record(host, dt)  # EVERY step: medians are real samples
        losses[s] = loss
        step_times[s] = dt

        if skipped:
            n_skipped += 1
            skip_streak += 1
            if skip_streak >= max_consecutive_nonfinite:
                raise NonFiniteEscalation(s, skip_streak, last_saved)
        else:
            skip_streak = 0

        if log_every and ((s + 1) % log_every == 0 or s == start_step):
            log_fn(
                f"[train] step {s + 1:5d} loss {loss:.4f} "
                f"lr {float(metrics.get('lr', float('nan'))):.2e} "
                f"{dt * 1e3:.0f} ms/step"
                + (f" (skipped, streak {skip_streak})" if skipped else "")
            )

        if faults is not None:
            faults.crash(s)  # post-update, pre-checkpoint: worst-case kill

        if mgr is not None and ckpt_every and (s + 1) % ckpt_every == 0:
            _save(s + 1)

    if mgr is not None:
        if last_saved != steps:
            _save(steps)
        mgr.wait()
    return LoopResult(
        last_step=steps,
        state=(params, opt_state),
        losses=losses,
        step_times=step_times,
        n_skipped=n_skipped,
        n_ckpt_failures=n_ckpt_failures,
    )
