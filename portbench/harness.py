"""The harness: one run of one cell, from ``BENCHMARK.json`` to the result line.

A cell names a configuration file (``configs/<config>.json``), a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` names the module under
``drivers/`` that serves it) and the limits of its output check
(``limits/<workload>.json``).  Every metric is read by a file of its own,
``metrics/<name>.py``, or one named ``<stem>.<part>`` by its stem's,
``metrics/<stem>.py``; its ``read(run)`` returns a number or ``None``.
Adding a cell, a mix or a metric is adding files and entries.

A run: the driver's ``setup`` (kernels built, weights drawn on the device,
the cell's own shapes warmed up), then its ``window`` for ``--seconds``,
then the device's peak memory is read, the program's state freed, and the
driver's ``check`` compares what the window produced with the plain
reference.  With ``--trace 1`` a few seconds inside the window run under
``torch.profiler``: the per-layer metrics read that trace, the spans this
package records around its calls into the program, and the program's
counters.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_DELAY_S = 1.0  # the traced part of the window starts this far in
PROFILE_S = 3.0  # and lasts this long (the window's end at the latest)

__all__ = ["ROOT", "Run", "Spans", "manifest", "load_cell", "run_cell", "main",
           "forbidden_modules", "reader_path"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def load_cell(man: dict, workload: str) -> tuple:
    """``(cell, cfg, mix, limits)`` of a workload, its files found by name."""
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    return (cell, _json(HERE / "configs" / f"{cell['config']}.json"),
            _json(HERE / "traffic" / f"{cell['traffic']}.json"),
            _json(HERE / "limits" / f"{workload}.json"))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


class Spans:
    """Host-clock spans around the calls into the program.  Traced, each is
    also a ``record_function`` (``portbench.<name>``), and a span made with
    ``sync=True`` waits for the device before it ends."""

    def __init__(self, trace: bool, cuda: bool):
        self.trace, self.cuda = trace, cuda
        self.items: list = []  # (name, t0, t1, attrs)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool = False, **attrs):
        rf = None
        if self.trace:
            import torch

            rf = torch.profiler.record_function(f"portbench.{name}")
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield attrs
        finally:
            if sync and self.trace and self.cuda:
                import torch

                torch.cuda.synchronize()
            self.items.append((name, t0, time.perf_counter(), attrs))
            if rf is not None:
                rf.__exit__(None, None, None)

    def within(self, name: str, t0: float, t1: float) -> list:
        return [s for s in self.items if s[0] == name and s[1] >= t0 and s[2] <= t1]


class Run:
    """One run's inputs and what its window recorded; the metric readers'
    only argument."""

    def __init__(self, cell, cfg, mix, limits, seed, seconds, trace, device,
                 t_proc0: float = math.nan):
        self.cell, self.cfg, self.mix, self.limits = cell, cfg, mix, limits
        self.t_proc0 = t_proc0
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.cuda = device.type == "cuda"
        self.spans = Spans(trace, self.cuda)
        self.t0 = self.t1 = math.nan
        self.setup_s = math.nan
        self.counters: dict = {}
        self.requests: list = []  # one dict a request due in the window (a driver's keys)
        self.attempted = self.failed = 0
        self.profile: Optional[dict] = None  # the traced part of the window
        self.state: dict = {}  # the driver's own
        self._prof = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def start_window(self) -> float:
        """Called by a driver where its window starts: set-up ends here."""
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_proc0
        return self.t0

    # -- the traced part of the window --------------------------------------

    def profile_tick(self, now: float) -> None:
        """Called by a driver between its steps: starts the profiler
        ``PROFILE_DELAY_S`` into the window and stops it ``PROFILE_S`` later."""
        if not self.trace:
            return
        if self._prof is None and self.profile is None and now >= self.t0 + PROFILE_DELAY_S:
            self._start_profile()
        elif self._prof is not None and now >= self._prof["t0"] + PROFILE_S:
            self.profile_stop()

    def _start_profile(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
        if self.cuda:
            torch.cuda.synchronize()
        rf = record_function("portbench.window")
        rf.__enter__()
        self._prof = {"prof": prof, "rf": rf, "t0": time.perf_counter()}

    def profile_stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        p = self._prof
        p["rf"].__exit__(None, None, None)
        p["prof"].__exit__(None, None, None)
        self._prof = None
        self.profile = summarize(p["prof"], p["t0"], t1)


def _events(prof) -> list:
    """``(name, start_ns, end_ns, on_device)`` of every traced event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        n = e.name()
        # the device timeline mirrors each record_function as an annotation:
        # no operation runs in it
        dev = (str(e.device_type()).split(".")[-1].upper() not in ("CPU", "0")
               and not e.is_user_annotation() and not n.startswith("portbench."))
        s = e.start_ns()
        out.append((n, s, s + e.duration_ns(), dev))
    return out


def summarize(prof, t0: float, t1: float) -> dict:
    """The traced window: device busy seconds (the union of every device
    operation's interval), each kernel's summed seconds, the longest device
    operations by name and the longest idle gaps, each labelled by the
    innermost ``portbench`` span the host was in at the gap's middle."""
    ev = _events(prof)
    win = [e for e in ev if e[0] == "portbench.window"]
    w0, w1 = (win[0][1], win[0][2]) if win else (min(e[1] for e in ev), max(e[2] for e in ev))
    dev = sorted((max(s, w0), min(e, w1), n) for n, s, e, d in ev if d and e > w0 and s < w1)
    by_name: dict = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
    merged: list = []
    for s, e, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged) * 1e-9
    edges = [w0] + [x for se in merged for x in se] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    host = [(s, e, n[len("portbench."):]) for n, s, e, d in ev
            if not d and n.startswith("portbench.") and n != "portbench.window"]

    def label(mid):
        inner = [h for h in host if h[0] <= mid <= h[1]]
        return min(inner, key=lambda h: h[1] - h[0])[2] if inner else "outside any span"

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return {
        "busy_s": busy, "window_s": t1 - t0, "host_t0": t0, "host_t1": t1,
        "kernel_s": by_name,
        "device_ops": [[n[:160], s] for n, s in
                       sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]],
        "idle_gaps": [[label((s + e) / 2), (e - s) * 1e-9] for s, e in gaps[:10]],
    }


# ---------------------------------------------------------------------------
# metrics, the device, the result line
# ---------------------------------------------------------------------------


def reader_path(name: str) -> Path:
    """A metric's reader: ``metrics/<name>.py``, else the reader of the
    name's stem before its first dot (``idle.serve`` reads with
    ``metrics/idle.py``)."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.is_file() else HERE / "metrics" / f"{name.split('.')[0]}.py"


def _reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end ones untraced,
    its per-layer ones traced."""
    e2e = [m for m in man["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def read_metrics(entries: list, run: Run) -> dict:
    out = {}
    for m in entries:
        v = _reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: dict, cfg: dict, mix: dict, limits: dict, seed: int, seconds: float,
             trace: bool, device, entries: list, t_proc0: float, log=_log) -> dict:
    """One run; returns the result line's object (``checks`` last).  The
    caller that prints it refuses a process that loaded JAX (:func:`main`)."""
    import torch

    device = torch.device(device)
    run = Run(cell, cfg, mix, limits, seed, seconds, trace, device, t_proc0)
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    log(f"before set-up: {nvidia_smi()}")
    driver.setup(run)
    if trace:  # the profiler's first start takes seconds: before any traffic
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU]
                     + ([ProfilerActivity.CUDA] if run.cuda else [])):
            pass
    driver.window(run)
    run.profile_stop()
    log(f"setup_s {run.setup_s:.3f}; window {run.window_s:.3f} s: attempted "
        f"{run.attempted}, failed {run.failed}, {run.counters}; {nvidia_smi()}")
    peak = torch.cuda.max_memory_allocated(device) if run.cuda else 0
    metrics = read_metrics(entries, run)
    driver.free(run)
    if run.cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = driver.check(run)
    log(f"check {time.perf_counter() - t:.3f} s")
    res = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": run.attempted, "failed": run.failed, "metrics": metrics,
        "device": {"platform": "gpu" if run.cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if run.cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(peak)},
    }
    if trace and run.profile is not None:
        res["device"]["busy_s"] = run.profile["busy_s"]
        res["device"]["window_s"] = run.profile["window_s"]
        res["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    res["checks"] = checks
    return res


def main(argv, t_proc0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    man = manifest()
    cell, cfg, mix, limits = load_cell(man, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        _log(f"needs {cell['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    res = run_cell(cell, cfg, mix, limits, a.seed, a.seconds, bool(a.trace),
                   "cuda:0", cell_metrics(man, a.workload, bool(a.trace)), t_proc0)
    bad = forbidden_modules()
    if bad:
        _log(f"loaded: {bad}")
        return 4
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(res), flush=True)
    return 0
