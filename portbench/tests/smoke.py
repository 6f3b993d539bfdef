"""Smoke-sized cells for the CPU tests: each cell's own files, with the
sizes under their ``smoke`` keys put in, which the plain CPU path runs in
seconds."""
from __future__ import annotations

import time

from portbench import harness


def cells(driver: str) -> list:
    """The manifest's workloads whose mix the ``driver`` serves."""
    return [c["name"] for c in harness.manifest()["workloads"]
            if harness._json(harness.HERE / "traffic" / f"{c['traffic']}.json")["driver"]
            == driver]


def cell(workload: str) -> tuple:
    """``(cell, cfg, mix, limits)`` of a workload at smoke size."""
    c, cfg, mix, limits = harness.load_cell(harness.manifest(), workload)
    return c, dict(cfg, **cfg["smoke"]), dict(mix, **mix["smoke"]), limits


def run(workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
        limits: dict = None) -> dict:
    c, cfg, mix, lim = cell(workload)
    return harness.run_cell(c, cfg, mix, dict(lim, **(limits or {})), seed, seconds, trace,
                            "cpu", harness.cell_metrics(harness.manifest(), workload, trace),
                            time.perf_counter(), log=lambda m: None)
