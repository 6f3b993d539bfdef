"""Per-request serving metrics: timestamps → p50/p99 rollups.

Port of ``repro.serve.metrics`` — pure Python, copied as it is.

Every request carries a :class:`Timeline` of wall-clock marks
(queue → admit → first token → done-or-failed).  :class:`Metrics` owns the
timelines plus slot-occupancy and failure-mode counters and rolls them up
into the serving numbers the launcher prints and
``benchmarks/serve_bench.py`` emits as BENCH_serve.json: p50/p99 end-to-end
latency, p50/p99 time-to-first-token, tok/s, img/s, mean slot occupancy,
SLO hit/miss counts, the fault-tolerance counters
(``n_rejected``/``n_shed``/``n_evicted_deadline``/``n_quarantined``/
``n_retried``/``n_degraded``), and per-failure-kind latency rows
(``failed_<kind>_{n,p50,p99}_latency_s``).

A failed request's timeline is terminal (``t_done`` is stamped at failure)
but is EXCLUDED from the ``done`` population — throughput, latency
percentiles, and SLO accounting describe successfully served requests only;
the failure rows describe the rest.

The clock is injectable (``Metrics(clock=...)``) so tests can drive
deterministic timelines; everything here is pure Python.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

__all__ = ["Timeline", "Metrics", "percentile", "FAILURE_COUNTERS"]

# every rollup carries these (0 when never incremented), so bench gates and
# dashboards can read them unconditionally
FAILURE_COUNTERS = (
    "n_rejected",  # refused at submit (bounded queue, policy="reject")
    "n_shed",  # dropped from the queue (expired SLO or shed_oldest victim)
    "n_evicted_deadline",  # evicted mid-decode after blowing the deadline
    "n_quarantined",  # slots quarantined by the numeric (isfinite) guard
    "n_retried",  # re-queued with backoff after a retryable fault
    "n_degraded",  # closures flipped kernel → dequant dispatch
    "n_faults_decode",  # transient decode faults (tick replayed, no state change)
)


@dataclasses.dataclass
class Timeline:
    """Wall-clock marks for one request (seconds, from the Metrics clock)."""

    kind: str  # "lm" | "cnn"
    t_submit: float
    t_admit: float = math.nan
    t_first: float = math.nan  # first decode token / classification result
    t_done: float = math.nan  # terminal stamp: completion OR failure
    n_out: int = 0  # tokens generated (lm) or images classified (cnn: 1)
    slo_s: Optional[float] = None  # per-request latency budget
    stuck: bool = False
    failed: Optional[str] = None  # deadline | numeric | error | rejected

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def ttft_s(self) -> float:
        return self.t_first - self.t_submit

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit

    @property
    def slo_met(self) -> Optional[bool]:
        if self.slo_s is None or math.isnan(self.t_done) or self.failed:
            return None
        return self.latency_s <= self.slo_s


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]); nan on empty input."""
    xs = sorted(x for x in xs if not math.isnan(x))
    if not xs:
        return math.nan
    rank = max(0, min(len(xs) - 1, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[rank]


class Metrics:
    """Request timelines + occupancy/failure counters with a p50/p99 rollup."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.clock = clock
        self.timelines: Dict[int, Timeline] = {}
        self.counters: Dict[str, int] = {}
        self._occ_ticks = 0
        self._occ_sum = 0.0

    # -- per-request marks ---------------------------------------------------

    def submit(self, uid, kind: str = "lm", *, slo_s: Optional[float] = None) -> Timeline:
        tl = Timeline(kind=kind, t_submit=self.clock(), slo_s=slo_s)
        self.timelines[uid] = tl
        return tl

    def mark_admit(self, uid):
        self.timelines[uid].t_admit = self.clock()

    def mark_first(self, uid):
        tl = self.timelines[uid]
        if math.isnan(tl.t_first):
            tl.t_first = self.clock()

    def mark_done(self, uid, n_out: int):
        tl = self.timelines[uid]
        tl.t_done = self.clock()
        tl.n_out = n_out

    def mark_failed(self, uid, kind: str, n_out: int = 0):
        """Terminal failure stamp: the request is over (its partial output,
        if any, is in ``n_out``) but never counts as served."""
        tl = self.timelines[uid]
        tl.t_done = self.clock()
        tl.failed = kind
        tl.n_out = n_out

    def mark_stuck(self, uid):
        self.timelines[uid].stuck = True

    def incr(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def tick_occupancy(self, live: int, slots: int):
        self._occ_ticks += 1
        self._occ_sum += live / max(slots, 1)

    # -- rollup --------------------------------------------------------------

    def rollup(self) -> dict:
        """All serving numbers in one dict (nan where no sample exists)."""
        done = [
            t
            for t in self.timelines.values()
            if not math.isnan(t.t_done) and t.failed is None
        ]
        out: dict = {"n_requests": len(self.timelines), "n_done": len(done),
                     "n_stuck": sum(t.stuck for t in self.timelines.values())}
        for kind, rate_name in (("lm", "tok_s"), ("cnn", "img_s")):
            ks = [t for t in done if t.kind == kind]
            lat = [t.latency_s for t in ks]
            out[f"{kind}_n"] = len(ks)
            out[f"{kind}_p50_latency_s"] = percentile(lat, 50)
            out[f"{kind}_p99_latency_s"] = percentile(lat, 99)
            out[f"{kind}_p50_ttft_s"] = percentile([t.ttft_s for t in ks], 50)
            out[f"{kind}_p99_ttft_s"] = percentile([t.ttft_s for t in ks], 99)
            if ks:
                t0 = min(t.t_submit for t in ks)
                t1 = max(t.t_done for t in ks)
                n = sum(t.n_out for t in ks)
                out[rate_name] = n / max(t1 - t0, 1e-9)
            else:
                out[rate_name] = math.nan
        slo = [t.slo_met for t in done if t.slo_met is not None]
        out["slo_met"] = sum(slo)
        out["slo_missed"] = len(slo) - sum(slo)
        out["mean_occupancy"] = (
            self._occ_sum / self._occ_ticks if self._occ_ticks else math.nan
        )
        # -- failure domains (DESIGN.md §2.4) --------------------------------
        for name in FAILURE_COUNTERS:
            out[name] = self.counters.get(name, 0)
        failed = [t for t in self.timelines.values() if t.failed]
        out["n_failed"] = len(failed)
        for kind in sorted({t.failed for t in failed}):
            ks = [t for t in failed if t.failed == kind]
            lat = [t.latency_s for t in ks]
            out[f"failed_{kind}_n"] = len(ks)
            out[f"failed_{kind}_p50_latency_s"] = percentile(lat, 50)
            out[f"failed_{kind}_p99_latency_s"] = percentile(lat, 99)
        return out
