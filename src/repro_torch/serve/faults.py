"""Deterministic fault injection for the serve stack.

Port of ``repro.serve.faults``, pure Python, carried whole.

A :class:`FaultPlan` is a *seeded, fully reproducible* schedule of faults —
no wall-clock anywhere: every fault is keyed to the engine's integer tick
counter, a slot index, or a request uid.  The engine calls the plan's thin
hook interface at its phase boundaries (tick start, prefill, decode,
closure dispatch), so chaos tests can assert three things about the same
injected schedule every run:

- unaffected requests' token streams stay **bit-identical** to a fault-free
  run (injection is side-effect-free outside the targeted slot/request);
- affected requests terminate with the right ``failed:*`` status;
- the engine always drains.

Fault kinds (``FaultSpec.kind``):

=========  ===============================================================
``nan``    poison slot ``slot``'s decode logits with NaN at tick ``tick``
           (exercises the numeric guard + slot quarantine path)
``prefill``  raise :class:`FaultInjected` on request ``uid``'s ``nth``
           admission attempt (transient error → retry with backoff)
``decode`` raise :class:`FaultInjected` before the batched decode at tick
           ``tick`` (whole-tick transient: the tick is a side-effect-free
           no-op and is replayed next tick — bit-exactness preserved)
``slow``   a latency spike: the engine sleeps ``delay_s`` at tick ``tick``
           (with an injected tick-clock this deterministically blows
           deadlines; with the real clock it is a genuine stall)
``kernel`` persistent per-closure failure: ``kernel_broken(key)`` stays
           true until the engine degrades that closure's dispatch from the
           kernel to the dequant oracle path (graceful degradation)
=========  ===============================================================
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

import numpy as np

__all__ = ["FAULT_KINDS", "FaultInjected", "FaultSpec", "FaultPlan"]

FAULT_KINDS = ("nan", "prefill", "decode", "slow", "kernel")


class FaultInjected(RuntimeError):
    """Raised by a :class:`FaultPlan` hook at the scheduled phase boundary."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"injected {kind} fault" + (f" ({detail})" if detail else ""))
        self.kind = kind


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  Only the fields its ``kind`` reads matter."""

    kind: str
    tick: int = 0  # nan | decode | slow: engine tick the fault fires on
    slot: int = 0  # nan: logits row to poison
    uid: int = 0  # prefill: target request uid
    nth: int = 1  # prefill: which admission attempt fails (1 = first)
    delay_s: float = 0.0  # slow: clock advance / sleep
    key: str = "decode"  # kernel: closure key ("decode" | "prefill:<bucket>")

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"kind must be one of {FAULT_KINDS}, got {self.kind!r}")


class FaultPlan:
    """A reproducible fault schedule plus the hooks the engine calls.

    Build explicitly from :class:`FaultSpec` s, or sample a schedule from a
    seed with :meth:`sample` (same seed ⇒ identical schedule, always — the
    plan never reads a clock or unseeded RNG).  ``fired`` records every hook
    activation ``(kind, detail...)`` in order, for test assertions.
    """

    def __init__(self, faults: Iterable[FaultSpec] = ()):
        self.faults: Tuple[FaultSpec, ...] = tuple(faults)
        self.fired: List[tuple] = []
        self._prefill_seen: dict = {}  # uid -> admission attempts observed

    @classmethod
    def sample(
        cls,
        seed: int,
        *,
        n_ticks: int,
        n_slots: int,
        n_requests: int,
        n_nan: int = 1,
        n_prefill: int = 1,
        n_decode: int = 1,
        n_slow: int = 0,
        slow_delay_s: float = 0.0,
        n_kernel: int = 0,
    ) -> "FaultPlan":
        """Draw a schedule from ``seed``: NaN/decode/slow faults land on
        ticks in ``[2, n_ticks)`` (tick 1 is the first admissions tick),
        prefill faults target uids in ``[1, n_requests]``."""
        rng = np.random.default_rng(seed)
        lo, hi = 2, max(3, n_ticks)
        faults: List[FaultSpec] = []
        for _ in range(n_nan):
            faults.append(FaultSpec("nan", tick=int(rng.integers(lo, hi)),
                                    slot=int(rng.integers(0, n_slots))))
        for _ in range(n_prefill):
            faults.append(FaultSpec("prefill", uid=int(rng.integers(1, n_requests + 1))))
        for _ in range(n_decode):
            faults.append(FaultSpec("decode", tick=int(rng.integers(lo, hi))))
        for _ in range(n_slow):
            faults.append(FaultSpec("slow", tick=int(rng.integers(lo, hi)),
                                    delay_s=slow_delay_s))
        for _ in range(n_kernel):
            faults.append(FaultSpec("kernel"))
        return cls(faults)

    # -- hooks the engine calls at its phase boundaries ----------------------

    def on_tick(self, tick: int) -> float:
        """Total ``slow`` delay scheduled at this tick (0.0 when none)."""
        d = sum(f.delay_s for f in self.faults if f.kind == "slow" and f.tick == tick)
        if d:
            self.fired.append(("slow", tick, d))
        return d

    def on_prefill(self, uid: int, tick: int) -> None:
        """Raise if ``uid``'s current admission attempt is scheduled to fail."""
        n = self._prefill_seen.get(uid, 0) + 1
        self._prefill_seen[uid] = n
        for f in self.faults:
            if f.kind == "prefill" and f.uid == uid and f.nth == n:
                self.fired.append(("prefill", uid, n, tick))
                raise FaultInjected("prefill", f"uid={uid} attempt={n}")

    def on_decode(self, tick: int) -> None:
        """Raise (transient, whole tick) if a decode fault lands on this tick."""
        for f in self.faults:
            if f.kind == "decode" and f.tick == tick:
                self.fired.append(("decode", tick))
                raise FaultInjected("decode", f"tick={tick}")

    def poison_slots(self, tick: int) -> List[int]:
        """Slots whose decode logits get NaN-poisoned at this tick."""
        slots = [f.slot for f in self.faults if f.kind == "nan" and f.tick == tick]
        if slots:
            self.fired.append(("nan", tick, tuple(slots)))
        return slots

    def kernel_broken(self, key: str) -> bool:
        """Persistent per-closure kernel failure — true on EVERY consult
        until the engine degrades the closure (the engine stops consulting
        once ``key`` is on the dequant path)."""
        hit = any(f.kind == "kernel" and f.key == key for f in self.faults)
        if hit:
            self.fired.append(("kernel", key))
        return hit
