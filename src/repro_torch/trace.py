"""Spans inside the port: what the program was doing, and for how long.

A span names one piece of work at the place it happens, with its host
times, the span that caused it and a few attributes; a device span also
times its work on the card with a pair of CUDA events.  The sites and
what each one covers:

========================  ====================================================
``batcher.stage``         ``CnnBatcher.flush``: a chunk's host staging (zero
                          fill, per-image copy, ``mark_admit``); ``n`` images
``batcher.h2d``           the chunk's copy to the device (device); ``n``
``engine.step``           one ``Engine.step`` tick, whole
``engine.prefill``        a request's prefill call (device); ``uid``
``engine.decode``         a tick's decode call (device)
``engine.readback``       the numeric guard's readback of tokens to the host
``attn.kv_write``         a KV-cache update: a decode step's one-position
                          write (device), a prefill's (host only)
``attn.decode``           single-token attention over the cache (device)
``train.step``            one call of ``make_train_step``'s step
``pasm.bwd_xg``           K1's backward ``xᵀg`` product, for the codebook
                          gradient (device)
``pasm.bin_sums``         the codebook gradient's per-bin sums of it (device)
========================  ====================================================

**Recording.**  Spans are off unless a ``torch.profiler`` profile is
running or the caller is inside :func:`recording`.  Either way,
:func:`take` returns the records made so far and clears them::

    with trace.recording():
        engine.run_until_drained()
    torch.cuda.synchronize()
    for r in trace.take():
        print(r.name, r.parent, r.host_ms, r.device_ms, r.attrs)

Under a profiler each span is also a ``record_function("repro_torch.<name>")``,
so an exported trace (``export_chrome_trace``, the one exporter) shows on
its own clock which span the host was in at any idle gap on the device.
Host times come from ``time.perf_counter``.  A span opened on a thread
that has none open (autograd's device thread runs the backward) takes as
its parent the newest span open on any thread: the ``train.step`` whose
backward it is.

**Cost.**  Off, a site costs a call and a flag test, a fraction of a
microsecond (PERF.md gives the measured figures).  On, a span takes a
lock, two clock reads, a record and, for a device span on the card, two
event records on the current stream (tens of microseconds); under a
profiler the ``record_function`` besides.  ``device_ms`` is read lazily: call it after
the device has finished the span's work (after a synchronize).
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Record", "span", "recording", "take"]


class Record:
    """One span: ``name``, host ``t0``/``t1`` (``time.perf_counter``),
    ``id`` and the ``parent`` span's id (``None`` at the top), ``attrs``."""

    __slots__ = ("id", "name", "parent", "t0", "t1", "attrs", "_events", "_ms")

    def __init__(self, id: int, name: str, parent: Optional[int], attrs: dict):
        self.id, self.name, self.parent, self.attrs = id, name, parent, attrs
        self.t0 = self.t1 = 0.0
        self._events = None
        self._ms = None

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.t1 - self.t0)

    @property
    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's events; ``None`` for a
        span timed on the host only.  Valid once the device has finished
        the span's work."""
        if self._events is not None:
            start, end = self._events
            self._ms = start.elapsed_time(end)
            _REC.pool.extend(self._events)
            self._events = None
        return self._ms


class _Recorder:
    """The process's records, the spans open on each thread, and a pool of
    timing events."""

    def __init__(self):
        self.depth = 0  # recording() entered and not yet left
        self.records: list = []
        self.open: dict = {}  # thread id -> its open records, innermost last
        self.pool: list = []
        self.ids = itertools.count(1)
        self.lock = threading.Lock()

    def enter(self, name: str, attrs: dict) -> Record:
        tid = threading.get_ident()
        with self.lock:
            stack = self.open.setdefault(tid, [])
            if stack:
                parent = stack[-1].id
            else:
                tops = [s[-1].id for s in self.open.values() if s]
                parent = max(tops) if tops else None
            rec = Record(next(self.ids), name, parent, attrs)
            stack.append(rec)
        return rec

    def leave(self, rec: Record) -> None:
        tid = threading.get_ident()
        with self.lock:
            stack = self.open[tid]
            stack.remove(rec)
            if not stack:
                del self.open[tid]
            self.records.append(rec)

    def event(self):
        return self.pool.pop() if self.pool else torch.cuda.Event(enable_timing=True)


_REC = _Recorder()


class _Off:
    """The span of a site while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "device", "attrs", "_rec", "_rf")

    def __init__(self, name: str, device: bool, attrs: dict):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> Record:
        self._rf = None
        if _profiler._is_profiler_enabled:
            self._rf = _profiler.record_function(f"repro_torch.{self.name}")
            self._rf.__enter__()
        rec = self._rec = _REC.enter(self.name, self.attrs)
        if self.device:
            rec._events = (_REC.event(), _REC.event())
            rec._events[0].record()
        rec.t0 = time.perf_counter()
        return rec

    def __exit__(self, *exc) -> bool:
        rec = self._rec
        if rec._events is not None:
            rec._events[1].record()
        rec.t1 = time.perf_counter()
        _REC.leave(rec)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str, *, device: bool = False, **attrs):
    """``with span(name, device=False, **attrs):`` records one span while a
    profiler runs or inside :func:`recording`; otherwise it is a flag test
    and a shared do-nothing context.  ``device=True`` (pass it only on a
    CUDA path) also times the span's work on the device."""
    if not (_REC.depth or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a profiler."""
    _REC.depth += 1
    try:
        yield
    finally:
        _REC.depth -= 1


def take() -> list:
    """The records made so far, in the order their spans ended; clears them."""
    with _REC.lock:
        out, _REC.records = _REC.records, []
    return out
