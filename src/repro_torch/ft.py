"""Fault tolerance: heartbeats, straggler detection, restart policy.

The port's own copy of ``repro.ft`` (it uses no JAX).

On a real fleet every host runs the same SPMD program; coordination happens
through (a) the distributed runtime's barrier and (b) this module's
host-side policies.  In this single-process container the same code runs
with n_hosts=1 and is unit-tested with synthetic timing traces.

* **Heartbeat / straggler detection**: per-step wall-times are all-gathered
  (here: recorded — EVERY step, so medians are real, not log-step samples);
  hosts slower than ``k × median`` over a sliding window are flagged.  The
  launcher's response is configurable: log, re-shard around the straggler
  (elastic restart), or abort-and-restore.
* **Restart policy with failure classification**: the supervisor around the
  train loop restores from the latest *valid* checkpoint on failure, but
  first CLASSIFIES the failure (DESIGN.md §4).  Exceptions that identify
  the failing step (a ``.step`` attribute — ``train.faults.SimulatedCrash``,
  ``train.loop.NonFiniteEscalation``, or a :class:`StepFailure` wrapper)
  build a failure signature ``(type, step)``: the SAME signature twice in a
  row means restore-and-retry already ran the step again and it failed the
  same way — the failure is *deterministic* (bad data, a bug, a poisoned
  batch that survives the guard) and the supervisor **fails fast** with
  :class:`DeterministicFailure` instead of burning the restart budget.
  Everything else is treated as transient: exponential-backoff restart,
  threading the exception's ``resume_step`` hint (when it carries one)
  into the next ``loop_fn(resume_step)`` call so the loop re-enters at the
  right checkpoint without re-resolving.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

__all__ = [
    "StragglerDetector",
    "RestartPolicy",
    "Supervisor",
    "RestorableError",
    "DeterministicFailure",
    "StepFailure",
]


class RestorableError(RuntimeError):
    """An error for which restore-from-checkpoint-and-continue is a
    meaningful response (e.g. the non-finite guard's escalation after K
    consecutive skipped steps: a transient numeric storm clears; a
    deterministic one repeats at the same step and is then failed fast)."""


class DeterministicFailure(RuntimeError):
    """The same step failed the same way twice across a restore — restarting
    again cannot help.  Raised by :class:`Supervisor` instead of burning the
    remaining restart budget; chains the underlying exception."""


class StepFailure(RuntimeError):
    """Wrapper a train loop may raise to attach step/resume info to an
    exception that has none: ``step`` is the failing step (classification
    key), ``resume_step`` the checkpoint hint for the next attempt."""

    def __init__(self, step: int, cause: BaseException, resume_step: Optional[int] = None):
        super().__init__(f"step {step} failed: {cause!r}")
        self.step = step
        self.cause = cause
        self.resume_step = resume_step


@dataclasses.dataclass
class StragglerDetector:
    """Flag hosts whose step time exceeds ``threshold ×`` the fleet median."""

    n_hosts: int
    window: int = 20
    threshold: float = 1.5

    def __post_init__(self):
        self._times = [deque(maxlen=self.window) for _ in range(self.n_hosts)]

    def record(self, host: int, step_time: float) -> None:
        self._times[host].append(step_time)

    def medians(self) -> list[float]:
        out = []
        for dq in self._times:
            s = sorted(dq)
            out.append(s[len(s) // 2] if s else 0.0)
        return out

    def stragglers(self) -> list[int]:
        meds = [m for m in self.medians() if m > 0]
        if not meds:
            return []
        fleet = sorted(meds)[len(meds) // 2]
        return [
            h
            for h, m in enumerate(self.medians())
            if m > self.threshold * fleet and m > 0
        ]


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 5
    backoff_s: float = 1.0
    backoff_mult: float = 2.0

    def delays(self):
        d = self.backoff_s
        for _ in range(self.max_restarts):
            yield d
            d *= self.backoff_mult


def failure_signature(exc: BaseException) -> Optional[tuple]:
    """``(type_name, step)`` when the exception identifies its failing step
    (a ``.step`` attribute, including :class:`StepFailure` — which keys on
    its *cause*'s type); None for stepless exceptions, which cannot be
    distinguished across attempts and stay on the legacy transient path."""
    step = getattr(exc, "step", None)
    if step is None:
        return None
    cause = getattr(exc, "cause", None)
    name = type(cause).__name__ if cause is not None else type(exc).__name__
    return (name, int(step))


class Supervisor:
    """Run ``loop_fn(resume_step) -> last_step`` under the restart policy.

    ``loop_fn`` must be restartable from a checkpoint (``repro_torch.launch.train`` is:
    it restores the latest *valid* manifest and the data stream is
    step-addressed).  Failures are classified per :func:`failure_signature`:
    a repeated same-step failure raises :class:`DeterministicFailure`
    immediately; transient ones restart with backoff, threading the
    exception's ``resume_step`` hint into the next attempt (None when the
    exception carries none — the loop then re-resolves the newest valid
    checkpoint itself).
    """

    def __init__(self, policy: RestartPolicy, *, sleep: Callable[[float], None] = time.sleep):
        self.policy = policy
        self.sleep = sleep
        self.restarts = 0
        self.failures: list[str] = []
        self.classified: list[tuple] = []  # (signature-or-None, verdict)

    def run(self, loop_fn: Callable[[Optional[int]], int], resume_step: Optional[int] = None) -> int:
        delays = self.policy.delays()
        last_sig: Optional[tuple] = None
        while True:
            try:
                return loop_fn(resume_step)
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — supervisor boundary
                self.failures.append(repr(e))
                sig = failure_signature(e)
                if sig is not None and sig == last_sig:
                    self.classified.append((sig, "deterministic"))
                    raise DeterministicFailure(
                        f"step {sig[1]} failed twice with {sig[0]} across a "
                        f"restore — deterministic, not restarting "
                        f"(restarts so far: {self.restarts})"
                    ) from e
                self.classified.append((sig, "transient"))
                last_sig = sig
                try:
                    delay = next(delays)
                except StopIteration:
                    raise RuntimeError(
                        f"exceeded max_restarts={self.policy.max_restarts}; "
                        f"failures: {self.failures}"
                    ) from e
                self.restarts += 1
                self.sleep(delay)
                # thread the failure's checkpoint hint through; loop_fn
                # re-resolves the newest valid checkpoint when None
                resume_step = getattr(e, "resume_step", None)
