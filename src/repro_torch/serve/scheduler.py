"""FCFS slot scheduler with bounded-queue admission control.

Port of ``repro.serve.scheduler``, pure Python, carried whole.

The scheduler owns the waiting queue and the slot table; the engine asks it
each tick which requests to prefill into which free slots.  Admission is
strictly FCFS — a request is admitted the moment a slot is free (continuous
batching; no wave gate).  Prompts are padded up to a *length bucket* so the
per-bucket prefill closures stay bounded: attention families use
power-of-two buckets (``pow2_bucket``), recurrent families (ssm/hybrid) use
exact lengths (``exact_bucket`` — their scans fold pad tokens into state, so
padded prompts are unsupported; see ``ssm_lm.prefill``).

Fault tolerance:

- **Bounded queue + policy**: ``max_queue`` caps the waiting deque; an
  overflowing submit follows ``policy`` — ``"reject"`` (refuse the new
  request: :class:`QueueFullError`), ``"shed_oldest"`` (drop the head of the
  queue to make room), or ``"shed_expired"`` (first shed queued requests
  whose deadline already passed; reject only if none had).
- **Deadline shedding**: :meth:`shed_expired` removes queued requests whose
  ``deadline`` (absolute, stamped by the engine from ``slo_s``) has passed —
  prefill compute is never spent on a request that already blew its SLO.
- **Quarantine**: a slot whose occupant hit a numeric fault is quarantined —
  excluded from ``free_slots`` until the engine re-grafts the fresh cache
  template over its stripe and calls :meth:`release` — so poisoned KV never
  leaks to the next occupant.
- **Total-footprint validation**: submit validates
  ``len(prompt) + max_new - 1 <= max_seq`` (prefill writes the prompt, each
  subsequent decode writes one token), not just the prompt length — a long
  prompt with a default ``max_new`` used to decode past the KV cache end and
  silently wrap/clobber.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, List, Optional

__all__ = [
    "pow2_bucket",
    "exact_bucket",
    "SlotPlan",
    "Scheduler",
    "QueueFullError",
    "ADMISSION_POLICIES",
]

ADMISSION_POLICIES = ("reject", "shed_oldest", "shed_expired")


class QueueFullError(RuntimeError):
    """Bounded queue overflow under ``policy="reject"`` (or no shed victim).

    ``shed`` carries requests the policy removed from the queue before the
    refusal (``shed_expired`` may shed and STILL reject when nothing had
    expired) — the caller must mark them failed even on this path.
    """

    def __init__(self, msg: str, shed: Optional[list] = None):
        super().__init__(msg)
        self.shed = list(shed or [])


def pow2_bucket(n: int, *, lo: int = 8, hi: Optional[int] = None) -> int:
    """Smallest power of two ≥ max(n, lo), capped at ``hi``."""
    b = lo
    while b < n:
        b *= 2
    return min(b, hi) if hi is not None else b


def exact_bucket(n: int, *, lo: int = 1, hi: Optional[int] = None) -> int:
    """Bucket granularity 1 — for families that cannot pad prompts."""
    b = max(n, lo)
    return min(b, hi) if hi is not None else b


@dataclasses.dataclass
class SlotPlan:
    """One admission decision: request → slot, prompt padded to ``bucket``."""

    req: object  # engine Request (has .uid and .prompt)
    slot: int
    bucket: int


class Scheduler:
    """FCFS admission over length buckets + slot lifecycle + backpressure."""

    def __init__(
        self,
        n_slots: int,
        *,
        bucket_fn: Callable[[int], int] = pow2_bucket,
        max_seq: Optional[int] = None,
        max_queue: Optional[int] = None,
        policy: str = "reject",
    ):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"policy must be one of {ADMISSION_POLICIES}, got {policy!r}")
        self.n_slots = n_slots
        self.bucket_fn = bucket_fn
        self.max_seq = max_seq
        self.max_queue = max_queue
        self.policy = policy
        self.waiting: Deque[object] = deque()
        self.slot_owner: List[Optional[int]] = [None] * n_slots  # uid per slot
        self.quarantined: set[int] = set()

    # -- queue/slot state ----------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    @property
    def free_slots(self) -> List[int]:
        return [
            i
            for i, uid in enumerate(self.slot_owner)
            if uid is None and i not in self.quarantined
        ]

    @property
    def live_slots(self) -> int:
        return sum(uid is not None for uid in self.slot_owner)

    # -- admission control ---------------------------------------------------

    def validate(self, req) -> None:
        """Reject a request whose KV footprint cannot fit: prefill writes
        ``len(prompt)`` positions, then each of the ``max_new - 1`` decode
        steps writes one more (the first token comes from prefill)."""
        if self.max_seq is None:
            return
        n = len(req.prompt)
        if n > self.max_seq:
            raise ValueError(f"prompt length {n} exceeds max_seq {self.max_seq}")
        max_new = int(getattr(req, "max_new", 0))
        footprint = n + max(max_new, 1) - 1
        if footprint > self.max_seq:
            raise ValueError(
                f"prompt ({n}) + max_new ({max_new}) needs {footprint} KV "
                f"positions but max_seq is {self.max_seq} — decode would wrap "
                f"past the cache end"
            )

    def submit(self, req, *, now: Optional[float] = None) -> list:
        """Enqueue ``req``; returns requests the policy shed to make room.

        Raises :class:`QueueFullError` (carrying any shed victims) when the
        bounded queue stays full — ``"reject"`` always, ``"shed_expired"``
        when no queued request had expired.  ``now`` is the engine clock,
        used only for expiry decisions.
        """
        self.validate(req)
        shed: list = []
        if self.max_queue is not None and len(self.waiting) >= self.max_queue:
            if self.policy == "shed_expired" and now is not None:
                shed = self.shed_expired(now)
            elif self.policy == "shed_oldest" and self.waiting:
                shed = [self.waiting.popleft()]
            if len(self.waiting) >= self.max_queue:
                raise QueueFullError(
                    f"queue full ({len(self.waiting)}/{self.max_queue}) under "
                    f"policy={self.policy!r}",
                    shed=shed,
                )
        self.waiting.append(req)
        return shed

    def shed_expired(self, now: float) -> list:
        """Remove and return queued requests whose deadline has passed."""
        keep: Deque[object] = deque()
        shed: list = []
        for r in self.waiting:
            deadline = getattr(r, "deadline", None)
            if deadline is not None and now > deadline:
                shed.append(r)
            else:
                keep.append(r)
        self.waiting = keep
        return shed

    def requeue(self, req) -> None:
        """Re-enter a retryable request at the queue tail.  Retries bypass
        the bounded-queue policy: the request was already admitted once, and
        rejecting internal retry traffic would turn a transient fault into a
        capacity failure."""
        self.waiting.append(req)

    # -- slot lifecycle ------------------------------------------------------

    def admit(self) -> List[SlotPlan]:
        """FCFS: fill free (non-quarantined) slots from the queue head."""
        plans: List[SlotPlan] = []
        free = self.free_slots
        while free and self.waiting:
            req = self.waiting.popleft()
            slot = free.pop(0)
            self.slot_owner[slot] = req.uid
            bucket = self.bucket_fn(len(req.prompt))
            if self.max_seq is not None:
                bucket = min(bucket, self.max_seq)
            plans.append(SlotPlan(req=req, slot=slot, bucket=bucket))
        return plans

    def quarantine(self, slot: int) -> None:
        """Mark a slot's cache stripe poisoned: no reuse until the engine
        re-grafts the fresh template and calls :meth:`release`."""
        self.slot_owner[slot] = None
        self.quarantined.add(slot)

    def release(self, slot: int) -> None:
        """Evict a completed (or scrubbed) request; the slot is reusable."""
        self.slot_owner[slot] = None
        self.quarantined.discard(slot)
