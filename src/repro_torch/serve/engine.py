"""Serving engine: continuous batching over prefill/decode with PASM weights.

Port of ``repro.serve.engine``.  Admission is CONTINUOUS: the moment a slot
is free, the next waiting request prefills into it while every other slot
keeps decoding.  The machinery that makes this exact:

- ``KVCache.pos`` is per slot, so each slot's reads and writes are masked at
  its own position and a mid-decode prefill never moves a live slot.
- Prefill runs batch-of-one against a FRESH single-slot cache, right-padded
  to a power-of-two length bucket, and the result is grafted into the
  batched cache at the slot index along each leaf's batch axis.  A reused
  slot never sees the previous occupant's KV, and a request's prefill is
  the same computation loaded or alone.
- The batch axis of every cache leaf is inferred once by diffing
  ``init_caches`` at two batch sizes on the ``meta`` device (the JAX
  package used ``jax.eval_shape``).

Fault tolerance, every leg through :meth:`Engine.step`: bounded queue with
an admission policy, deadline shedding and eviction, one fused ``isfinite``
guard per tick with slot quarantine and a scrub from the fresh template,
retries with capped exponential tick backoff, and the seeded
:class:`~repro_torch.serve.faults.FaultPlan` hooks.

**Degradation differs from the JAX package on purpose.**  The JAX engine
catches any exception at a jit boundary and replays the closure on the
``dequant`` path.  On the card that would hide a failing kernel behind a
fallback, so here only an injected ``FaultPlan`` kernel fault
(``faults.kernel_broken(key)``) flips a closure to ``dequant`` (memoized,
counted in ``n_degraded``); any real exception from a kernel or its build
propagates (ROADMAP Queue 3).

PyTorch runs eagerly: the per-bucket and per-impl closures are plain
functions, memoized only so that degradation flips one closure.  The engine
owns its batched cache and grafts into it in place; prefill and decode
return new caches and never change their inputs.  It runs on the device of
``params``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.configs.base import ArchConfig
from repro_torch.models import api
from repro_torch.serve.faults import FaultInjected, FaultPlan
from repro_torch.serve.metrics import Metrics
from repro_torch.serve.scheduler import QueueFullError, Scheduler, exact_bucket, pow2_bucket

__all__ = ["Request", "Engine"]

# Families whose prefill supports right-padded prompts (``lengths=``).
_PADDED_FAMILIES = ("dense", "moe", "vlm", "audio")

# failure kinds that re-enter the queue (deadline/rejected are final)
_RETRYABLE = ("numeric", "error")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int = 16
    slo_s: Optional[float] = None
    deadline: Optional[float] = None  # absolute, on the metrics clock
    out: list = dataclasses.field(default_factory=list)
    done: bool = False
    stuck: bool = False
    failed: Optional[str] = None  # deadline | numeric | error | rejected
    retries: int = 0
    retry_at: int = 0  # engine tick the next attempt may re-queue at
    slot: int = -1

    @property
    def status(self) -> str:
        """Terminal taxonomy: ``done | stuck | failed:<kind>`` (else pending)."""
        if self.done:
            return "done"
        if self.failed:
            return f"failed:{self.failed}"
        if self.stuck:
            return "stuck"
        return "pending"


def _cache_map(fn: Callable, *trees):
    """``fn(*leaves)`` over cache trees: dicts, lists and cache dataclasses
    of tensors (or of anything, for the inferred axes)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _cache_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_cache_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t0):  # a metadata field (seq_shards) stays t0's
        return type(t0)(**{f.name: _cache_map(fn, *(getattr(t, f.name) for t in trees))
                           if isinstance(getattr(t0, f.name), torch.Tensor)
                           else getattr(t0, f.name) for f in dataclasses.fields(t0)})
    return fn(*trees)


def _infer_batch_axes(model, cfg, max_seq):
    """Per-leaf batch axis of the cache tree (shapes at B=2 vs 3, on meta)."""
    s2 = model.init_caches(cfg, 2, max_seq, device="meta")
    s3 = model.init_caches(cfg, 3, max_seq, device="meta")

    def ax(a, b):
        diffs = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diffs) != 1:
            raise ValueError(f"cache leaf has no unique batch axis: {a.shape} vs {b.shape}")
        return diffs[0]

    return _cache_map(ax, s2, s3)


def _params_device(params) -> torch.device:
    """The device of the first tensor in a params tree."""
    if isinstance(params, torch.Tensor):
        return params.device
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        for p in params:
            dev = _params_device(p)
            if dev is not None:
                return dev
        return None
    if dataclasses.is_dataclass(params):
        return _params_device([getattr(params, f.name) for f in dataclasses.fields(params)])
    return None


class Engine:
    """Continuously batched autoregressive server for the ported archs.

    ``calls`` counts the prefill and decode model calls made (``{"prefill":
    n, "decode": n}``): with the kernel launch counters it shows which
    kernels each call ran.
    """

    def __init__(
        self,
        cfg: ArchConfig,
        params,
        *,
        batch_slots: int = 4,
        max_seq: int = 256,
        greedy: bool = True,
        clock: Callable[[], float] = time.perf_counter,
        metrics: Optional[Metrics] = None,
        faults: Optional[FaultPlan] = None,
        max_retries: int = 1,
        backoff_ticks: int = 1,
        backoff_cap_ticks: int = 8,
        max_queue: Optional[int] = None,
        policy: str = "reject",
        deadline_eviction: bool = True,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.cfg = cfg
        self.model = api.get_model(cfg)
        self.params = params
        self.device = _params_device(params)
        self._cuda = self.device is not None and self.device.type == "cuda"
        self.batch = batch_slots
        self.max_seq = max_seq
        self.greedy = greedy
        self.supports_lengths = cfg.family in _PADDED_FAMILIES
        bucket = pow2_bucket if self.supports_lengths else exact_bucket
        self.sched = Scheduler(
            batch_slots,
            bucket_fn=lambda n: bucket(n, hi=max_seq),
            max_seq=max_seq,
            max_queue=max_queue,
            policy=policy,
        )
        self.metrics = metrics if metrics is not None else Metrics(clock=clock)
        self.faults = faults
        self.max_retries = max_retries
        self.backoff_ticks = backoff_ticks
        self.backoff_cap_ticks = backoff_cap_ticks
        self.deadline_eviction = deadline_eviction
        self.live: dict[int, Request] = {}
        self.tick = 0
        self._uid = 0
        self._sleep = sleep
        self._retry_q: list[Request] = []
        self._needs_scrub: set[int] = set()
        self.calls = {"prefill": 0, "decode": 0}
        # injected-fault degradation: closures flipped to the dequant oracle
        # (one-way, memoized; None when there is nothing to degrade to)
        self._degraded: set[str] = set()
        q = cfg.quant
        self._degraded_cfg = (
            cfg.with_quant(impl="dequant")
            if q.enabled and q.impl not in ("dequant", "dense")
            else None
        )

        # one long-lived batched cache + a fresh single-slot template for
        # every admission and every quarantine scrub
        self.caches = self.model.init_caches(cfg, self.batch, max_seq, device=self.device)
        self._one_template = self.model.init_caches(cfg, 1, max_seq, device=self.device)
        self._slot_axes = _infer_batch_axes(self.model, cfg, max_seq)
        self._decode_by_impl: dict[str, Callable] = {}
        self._prefill_by_bucket: dict[tuple, Callable] = {}

    # -- cache graft and the numeric guard -----------------------------------

    def _graft(self, one, slot: int) -> None:
        """Copy the single-slot cache ``one`` into slot ``slot`` of the
        batched cache, along each leaf's batch axis (in place)."""
        def put(b, o, a):
            b.narrow(a, slot, 1).copy_(o)
            return b

        _cache_map(put, self.caches, one, self._slot_axes)

    @staticmethod
    def _guard(logits: torch.Tensor) -> tuple:
        """Numeric guard + argmax: one ``isfinite`` reduction per slot over
        its logits, and the next token, both brought to the host once."""
        with trace.span("engine.readback"):
            fin = torch.isfinite(logits).flatten(1).all(dim=1)
            nxt = torch.argmax(logits[:, 0], dim=-1)
            return nxt.cpu().numpy(), fin.cpu().numpy()

    # -- closures (per cfg-impl, so degradation can rebuild) -----------------

    def _impl_key(self, cfg) -> str:
        return cfg.quant.impl if cfg.quant.enabled else "dense"

    def _decode_fn(self, cfg) -> Callable:
        key = self._impl_key(cfg)
        if key not in self._decode_by_impl:
            model = self.model

            def f(params, tokens, caches):
                return model.decode_step(params, tokens, caches, cfg)

            self._decode_by_impl[key] = f
        return self._decode_by_impl[key]

    def _prefill_fn(self, bucket: int, cfg) -> Callable:
        key = (bucket, self._impl_key(cfg))
        if key not in self._prefill_by_bucket:
            model = self.model
            if self.supports_lengths:
                def f(params, tokens, lengths, caches):
                    return model.prefill(params, tokens, caches, cfg, lengths=lengths)
            else:  # exact-length prompt: no pads, lengths unused
                def f(params, tokens, lengths, caches):
                    del lengths
                    return model.prefill(params, tokens, caches, cfg)
            self._prefill_by_bucket[key] = f
        return self._prefill_by_bucket[key]

    def _call(self, key: str, build: Callable, *args):
        """Run a closure, degrading it to ``dequant`` on an injected kernel
        fault only.

        An injected ``FaultPlan`` kernel fault flips THIS closure's dispatch
        to the dequant oracle, memoized, and runs it there: degraded but
        serving.  Without a dequant path to degrade to it raises.  Any other
        exception propagates: a real kernel failure is never served around.
        """
        degraded = key in self._degraded
        if (not degraded and self.faults is not None
                and self.faults.kernel_broken(key)):
            if self._degraded_cfg is None:
                raise RuntimeError(f"injected persistent kernel failure: {key}")
            self._degraded.add(key)
            self.metrics.incr("n_degraded")
            warnings.warn(
                f"engine: injected kernel failure in closure {key!r} on the "
                f"{self.cfg.quant.impl!r} path; degrading its dispatch to "
                f"impl='dequant'",
                RuntimeWarning,
                stacklevel=2,
            )
            degraded = True
        out = build(self._degraded_cfg if degraded else self.cfg)(*args)
        self.calls[key.split(":")[0]] += 1
        return out

    # -- request lifecycle ---------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new: int = 16,
               *, slo_s: Optional[float] = None) -> Request:
        """Submit a request.  Under a bounded queue the returned request may
        already be terminal (``failed="rejected"``) — check ``.status``."""
        self._uid += 1
        r = Request(uid=self._uid, prompt=np.asarray(prompt, np.int32),
                    max_new=max_new, slo_s=slo_s)
        self.sched.validate(r)  # raises before any registration
        now = self.metrics.clock()
        if slo_s is not None:
            r.deadline = now + slo_s
        self.metrics.submit(r.uid, "lm", slo_s=slo_s)
        try:
            shed = self.sched.submit(r, now=now)
        except QueueFullError as e:
            r.failed = "rejected"
            self.metrics.incr("n_rejected")
            self.metrics.mark_failed(r.uid, "rejected")
            shed = e.shed
        for victim in shed:
            self._mark_shed(victim, now)
        return r

    @property
    def waiting(self):
        return self.sched.waiting

    @property
    def busy(self) -> bool:
        """Work anywhere in the engine: live slots, queue, or pending retries."""
        return bool(self.live or self.sched.waiting or self._retry_q)

    # -- failure paths -------------------------------------------------------

    def _mark_shed(self, r: Request, now: float) -> None:
        """A queued request dropped by backpressure: ``deadline`` when its SLO
        had expired, ``rejected`` when it was a capacity (shed_oldest) victim."""
        kind = "deadline" if r.deadline is not None and now > r.deadline else "rejected"
        r.failed = kind
        self.metrics.incr("n_shed")
        self.metrics.mark_failed(r.uid, kind, n_out=len(r.out))

    def _fail_or_retry(self, r: Request, kind: str) -> None:
        """Retryable fault: re-queue with capped exponential tick backoff
        (``backoff_ticks · 2^(attempt-1)``, capped); else terminal failure
        with the partial output preserved on the request."""
        if kind in _RETRYABLE and r.retries < self.max_retries:
            r.retries += 1
            delay = min(self.backoff_ticks * (2 ** (r.retries - 1)), self.backoff_cap_ticks)
            r.retry_at = self.tick + delay
            r.slot = -1
            r.out = []  # the retry re-prefills and decodes fresh
            self._retry_q.append(r)
            self.metrics.incr("n_retried")
        else:
            r.failed = kind
            self.metrics.mark_failed(r.uid, kind, n_out=len(r.out))

    def _quarantine(self, r: Request, kind: str = "numeric") -> None:
        """Numeric fault in ``r``'s slot: quarantine the slot (no reuse until
        its cache stripe is re-grafted from the fresh template) and fail or
        retry the occupant."""
        self.sched.quarantine(r.slot)
        self._needs_scrub.add(r.slot)
        self.metrics.incr("n_quarantined")
        self.live.pop(r.uid, None)
        self._fail_or_retry(r, kind)

    def _scrub_quarantined(self) -> None:
        """Re-initialize quarantined slots' cache stripes from the fresh
        template, then release them."""
        for slot in sorted(self._needs_scrub):
            self._graft(self._one_template, slot)
            self.sched.release(slot)
        self._needs_scrub.clear()

    def _shed_expired_queued(self, now: float) -> None:
        """Shed queued requests whose SLO already expired — prefill compute
        is never spent on a request that cannot meet its deadline."""
        for r in self.sched.shed_expired(now):
            r.failed = "deadline"
            self.metrics.incr("n_shed")
            self.metrics.mark_failed(r.uid, "deadline", n_out=len(r.out))

    def _evict_deadline(self, now: float) -> None:
        """Mid-decode eviction: a live request past its deadline frees the
        slot immediately; its partial output stays on ``r.out``."""
        for r in list(self.live.values()):
            if r.deadline is not None and now > r.deadline:
                del self.live[r.uid]
                self.sched.release(r.slot)
                r.failed = "deadline"
                self.metrics.incr("n_evicted_deadline")
                self.metrics.mark_failed(r.uid, "deadline", n_out=len(r.out))

    def _requeue_retries(self) -> None:
        ready = [r for r in self._retry_q if r.retry_at <= self.tick]
        if ready:
            self._retry_q = [r for r in self._retry_q if r.retry_at > self.tick]
            for r in ready:
                self.sched.requeue(r)

    # -- admission -----------------------------------------------------------

    @torch.no_grad()
    def _admit(self):
        """Continuous admission: prefill each planned request immediately,
        batch-of-one against the fresh template, right-padded to the
        scheduler's length bucket, then graft into the batched cache at the
        slot.  Injected prefill faults fail the request into the retry path;
        the first-token logits pass the same numeric guard decode uses."""
        self._scrub_quarantined()
        for plan in self.sched.admit():
            r = plan.req
            try:
                if self.faults is not None:
                    self.faults.on_prefill(r.uid, self.tick)
                S = max(plan.bucket, len(r.prompt))
                toks = np.zeros((1, S), np.int32)
                toks[0, : len(r.prompt)] = r.prompt  # right-pad (left-aligned)
                lengths = torch.tensor([len(r.prompt)], dtype=torch.int32,
                                       device=self.device)
                with trace.span("engine.prefill", device=self._cuda, uid=r.uid):
                    logits, one_caches = self._call(
                        f"prefill:{S}",
                        lambda cfg, S=S: self._prefill_fn(S, cfg),
                        self.params, torch.from_numpy(toks).to(self.device), lengths,
                        self._one_template,
                    )
            except FaultInjected:
                self.sched.release(plan.slot)
                self._fail_or_retry(r, "error")
                continue
            tok, ok = self._guard(logits[:, -1:])
            if not bool(ok[0]):
                # poisoned prefill: never graft; quarantine scrubs the slot
                r.slot = plan.slot
                self.live[r.uid] = r
                self._quarantine(r)
                continue
            self._graft(one_caches, plan.slot)
            r.slot = plan.slot
            r.out.append(int(tok[0]))
            self.live[r.uid] = r
            self.metrics.mark_admit(r.uid)
            self.metrics.mark_first(r.uid)

    # -- the tick ------------------------------------------------------------

    @torch.no_grad()
    def step(self):
        """One engine tick: enforce deadlines/backpressure, re-queue ready
        retries, admit, then decode one token for every live slot (dead
        slots decode a dummy token, ignored)."""
        self.tick += 1
        with trace.span("engine.step"):
            now = self.metrics.clock()
            if self.faults is not None:
                delay = self.faults.on_tick(self.tick)
                if delay:
                    self._sleep(delay)
                    now = self.metrics.clock()
            self._shed_expired_queued(now)
            self._requeue_retries()
            if self.deadline_eviction:
                self._evict_deadline(now)
            self._admit()
            if not self.live:
                return
            toks = np.zeros((self.batch, 1), np.int32)
            for r in self.live.values():
                toks[r.slot, 0] = r.out[-1]
            try:
                if self.faults is not None:
                    self.faults.on_decode(self.tick)
                with trace.span("engine.decode", device=self._cuda):
                    logits, caches = self._call(
                        "decode", self._decode_fn, self.params,
                        torch.from_numpy(toks).to(self.device), self.caches,
                    )
            except FaultInjected:
                # transient decode fault: the tick is a side-effect-free no-op
                # (caches untouched) and replays next tick — bit-exactness holds
                self.metrics.incr("n_faults_decode")
                return
            self.caches = caches
            if self.faults is not None:
                for s in self.faults.poison_slots(self.tick):
                    logits[s] = float("nan")
            nxt, ok = self._guard(logits)
            finished, poisoned = [], []
            for r in self.live.values():
                if not ok[r.slot]:
                    poisoned.append(r)
                    continue
                r.out.append(int(nxt[r.slot]))
                if len(r.out) >= r.max_new:
                    r.done = True
                    finished.append(r)
            for r in poisoned:
                self._quarantine(r)
            for r in finished:
                del self.live[r.uid]
                self.sched.release(r.slot)
                self.metrics.mark_done(r.uid, len(r.out))
            self.metrics.tick_occupancy(len(self.live) + len(finished) + len(poisoned), self.batch)

    def run_until_drained(self, max_ticks: int = 1000, *, strict: bool = True) -> int:
        """Tick until every request reaches a terminal status.  If
        ``max_ticks`` hits with requests still live/queued/retrying, mark
        them ``stuck`` and raise (or ``warnings.warn`` when
        ``strict=False``) instead of silently returning."""
        t = 0
        while self.busy and t < max_ticks:
            self.step()
            t += 1
        leftover = list(self.live.values()) + list(self.sched.waiting) + list(self._retry_q)
        if leftover:
            for r in leftover:
                r.stuck = True
                self.metrics.mark_stuck(r.uid)
            msg = (
                f"run_until_drained: {len(leftover)} request(s) undrained after "
                f"{max_ticks} ticks (uids {[r.uid for r in leftover]})"
            )
            if strict:
                raise RuntimeError(msg)
            warnings.warn(msg, RuntimeWarning, stacklevel=2)
        return t
