"""The program's own spans (``repro_torch.trace``) for the metric readers.

The program records them while a profiler runs, so a traced run's records
cover the traced part of the window.  They are taken from the program once
per run and kept in ``run.state``; a reader sees only those that lie
inside ``[host_t0, host_t1]``.  A program without the recorder gives no
records, and its readers return ``None``.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["records", "named", "device_ms_per"]


def records(run) -> list:
    """The program's records inside the traced part of the window."""
    p = run.profile
    if p is None:
        return []
    if "program_spans" not in run.state:
        try:
            from repro_torch import trace
        except ImportError:  # a program that records no spans
            run.state["program_spans"] = []
        else:
            run.state["program_spans"] = trace.take()
    return [r for r in run.state["program_spans"]
            if r.t0 >= p["host_t0"] and r.t1 <= p["host_t1"]]


def named(recs: list, name: str, under: Optional[str] = None) -> list:
    """The records called ``name`` (with an ancestor called ``under``)."""
    by_id = {r.id: r for r in recs}

    def inside(r) -> bool:
        while r.parent in by_id:
            r = by_id[r.parent]
            if r.name == under:
                return True
        return False

    return [r for r in recs if r.name == name and (under is None or inside(r))]


def device_ms_per(run, name: str, per: str, under: Optional[str] = None) -> Optional[float]:
    """The device ms of the spans called ``name`` (under ``under``), summed,
    over the number of spans called ``per``; ``None`` where there is no
    ``per`` span or a span was timed on the host only."""
    recs = records(run)
    n = len(named(recs, per))
    ms = [r.device_ms for r in named(recs, name, under)]
    if not n or None in ms:
        return None
    return sum(ms) / n
