"""Deterministic fault injection for the training loop (DESIGN.md §4).

The port's own copy of ``repro.train.faults``: it draws from numpy, so the
same seed samples the same plan in both packages.

The serve stack's chaos discipline (serve/faults.py) applied to training: a
:class:`TrainFaultPlan` is a *seeded, fully reproducible* schedule of faults
keyed to the integer **training step** — no wall clock anywhere — consulted
by train/loop.py at its phase boundaries (data fetch, loss, post-update,
checkpoint save).  Because the data pipeline is step-addressed and every
fault is step-keyed, the chaos suites (tests/test_train_faults.py,
tests/test_torch_train_faults.py) can assert the two training invariants
*bit-exactly*:

- resume-after-crash reproduces the uninterrupted loss trajectory and final
  params (the crashed steps are recomputed from the restored checkpoint on
  the identical step-addressed batches);
- a poisoned step (NaN loss / gradient spike) leaves params and opt_state
  bit-identical to the pre-step state (the fused guard's skip path).

Fault kinds (``TrainFaultSpec.kind``):

============  ==========================================================
``nan_loss``  ``loss_scale(step)`` returns NaN — the loss (and through
              the chain rule every gradient) goes non-finite; exercises
              the fused guard's skip path
``grad_spike``  ``loss_scale(step)`` returns ``spec.scale`` (default
              ``inf``) — the loss and every gradient blow up to inf,
              modelling an overflow rather than a NaN payload
``ckpt_io``   ``on_ckpt_save(step)`` raises :class:`OSError` on the
              ``nth`` save attempt at ``step`` (torn/failed write; the
              loop warns, counts, and keeps training)
``data_io``   ``on_data(step)`` raises :class:`OSError` on the ``nth``
              fetch attempt at ``step`` (transient storage flake; the
              capped-backoff retry in data/pipeline.py absorbs it)
``crash``     ``crash(step)`` raises :class:`SimulatedCrash` on the
              ``nth`` visit of ``step`` — after the update, before the
              step's checkpoint (the worst spot: the supervisor must
              restore an OLDER checkpoint and recompute)
``slow``      ``slow_delay(step)`` returns ``delay_s`` — a virtual
              straggler stall the loop adds to its recorded step time
              (zero wall clock)
============  ==========================================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional, Tuple

import numpy as np

__all__ = ["TRAIN_FAULT_KINDS", "SimulatedCrash", "TrainFaultSpec", "TrainFaultPlan"]

TRAIN_FAULT_KINDS = ("nan_loss", "grad_spike", "ckpt_io", "data_io", "crash", "slow")


class SimulatedCrash(RuntimeError):
    """An injected mid-run kill.  Carries ``step`` so ft.Supervisor can
    classify a repeat at the same step as deterministic."""

    def __init__(self, step: int):
        super().__init__(f"injected crash at step {step}")
        self.step = step


@dataclasses.dataclass(frozen=True)
class TrainFaultSpec:
    """One scheduled training fault.  Only the fields its ``kind`` reads
    matter: ``step`` keys every kind; ``nth`` makes ``ckpt_io``/``data_io``/
    ``crash`` one-shot per attempt count (1 = first attempt fails, the retry
    or restart passes); ``scale`` is the ``grad_spike`` loss multiplier;
    ``delay_s`` the ``slow`` stall."""

    kind: str
    step: int = 0
    nth: int = 1
    scale: float = float("inf")  # guaranteed non-finite in any float dtype
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in TRAIN_FAULT_KINDS:
            raise ValueError(
                f"kind must be one of {TRAIN_FAULT_KINDS}, got {self.kind!r}"
            )


class TrainFaultPlan:
    """A reproducible training fault schedule plus the hooks the loop calls.

    Build explicitly from :class:`TrainFaultSpec` s, or sample a schedule
    from a seed with :meth:`sample` (same seed ⇒ identical schedule — the
    plan never reads a clock or unseeded RNG).  ``fired`` records every hook
    activation in order, for test assertions.  Attempt counters
    (``nth``-keyed kinds) are instance state: a plan replayed across
    supervisor restarts keeps counting, so a ``crash`` with ``nth=1`` fires
    once and lets the restarted attempt pass.
    """

    def __init__(self, faults: Iterable[TrainFaultSpec] = ()):
        self.faults: Tuple[TrainFaultSpec, ...] = tuple(faults)
        self.fired: List[tuple] = []
        self._attempts: dict = {}  # (kind, step) -> attempts observed

    @classmethod
    def sample(
        cls,
        seed: int,
        *,
        n_steps: int,
        n_nan: int = 1,
        n_spike: int = 1,
        n_ckpt_io: int = 1,
        n_data_io: int = 1,
        n_crash: int = 1,
        n_slow: int = 0,
        slow_delay_s: float = 0.0,
        first_step: int = 1,
    ) -> "TrainFaultPlan":
        """Draw a schedule from ``seed``: every fault lands on a step in
        ``[first_step, n_steps)`` (step 0 is left clean so the first update
        always establishes a baseline)."""
        rng = np.random.default_rng(seed)
        lo, hi = first_step, max(first_step + 1, n_steps)
        pick = lambda: int(rng.integers(lo, hi))  # noqa: E731
        faults: List[TrainFaultSpec] = []
        for _ in range(n_nan):
            faults.append(TrainFaultSpec("nan_loss", step=pick()))
        for _ in range(n_spike):
            faults.append(TrainFaultSpec("grad_spike", step=pick()))
        for _ in range(n_ckpt_io):
            faults.append(TrainFaultSpec("ckpt_io", step=pick()))
        for _ in range(n_data_io):
            faults.append(TrainFaultSpec("data_io", step=pick()))
        for _ in range(n_crash):
            faults.append(TrainFaultSpec("crash", step=pick()))
        for _ in range(n_slow):
            faults.append(TrainFaultSpec("slow", step=pick(), delay_s=slow_delay_s))
        return cls(faults)

    def _nth_hit(self, kind: str, step: int) -> Optional[TrainFaultSpec]:
        """Count an attempt of (kind, step); return the spec if its ``nth``
        attempt is the one scheduled to fail."""
        specs = [f for f in self.faults if f.kind == kind and f.step == step]
        if not specs:
            return None
        key = (kind, step)
        n = self._attempts.get(key, 0) + 1
        self._attempts[key] = n
        for f in specs:
            if f.nth == n:
                return f
        return None

    # -- hooks the train loop calls at its phase boundaries ------------------

    def loss_scale(self, step: int) -> Optional[float]:
        """NaN (``nan_loss``) or the spike multiplier (``grad_spike``)
        scheduled for this step's loss; None when the step is clean."""
        for f in self.faults:
            if f.step == step and f.kind == "nan_loss":
                self.fired.append(("nan_loss", step))
                return float("nan")
            if f.step == step and f.kind == "grad_spike":
                self.fired.append(("grad_spike", step, f.scale))
                return f.scale
        return None

    def on_data(self, step: int) -> None:
        """Raise ``OSError`` if this step's ``nth`` data fetch is scheduled
        to fail (transient — the pipeline's capped-backoff retry absorbs it)."""
        f = self._nth_hit("data_io", step)
        if f is not None:
            self.fired.append(("data_io", step, f.nth))
            raise OSError(f"injected data I/O error at step {step}")

    def on_ckpt_save(self, step: int) -> None:
        """Raise ``OSError`` if this step's ``nth`` checkpoint save is
        scheduled to fail."""
        f = self._nth_hit("ckpt_io", step)
        if f is not None:
            self.fired.append(("ckpt_io", step, f.nth))
            raise OSError(f"injected checkpoint I/O error at step {step}")

    def crash(self, step: int) -> None:
        """Raise :class:`SimulatedCrash` on the scheduled visit of ``step``
        (fires after the update, before the step's checkpoint)."""
        f = self._nth_hit("crash", step)
        if f is not None:
            self.fired.append(("crash", step, f.nth))
            raise SimulatedCrash(step)

    def slow_delay(self, step: int) -> float:
        """Total virtual straggler stall scheduled at this step (0.0 = none)."""
        d = sum(f.delay_s for f in self.faults if f.kind == "slow" and f.step == step)
        if d:
            self.fired.append(("slow", step, d))
        return d

    @property
    def poison_steps(self) -> set:
        """Steps whose update the guard is expected to skip."""
        return {f.step for f in self.faults if f.kind in ("nan_loss", "grad_spike")}

    @property
    def trajectory_preserving(self) -> bool:
        """True when no fault alters the math (no nan/spike): the faulted
        run's loss trajectory must then be bit-exact vs fault-free."""
        return not self.poison_steps and not any(
            math.isnan(f.delay_s) for f in self.faults
        )
