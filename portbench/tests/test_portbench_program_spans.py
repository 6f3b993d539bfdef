"""The readers of the program's own spans (``portbench/program_spans.py``).

Each reader is held to a hand-made run whose records give a known value a
tick, a batch or a step: an ``attn.kv_write`` under ``engine.prefill`` is
left out of ``kv_write_ms``, records outside the traced part of the window
are ignored, and a run with no records, or a program with no recorder,
reads ``None``.  On the card (``gpu``): the program's annotations are not
counted as device work, and a device span's ``device_ms`` covers its
kernel.
"""
import sys
import time
from types import SimpleNamespace

import pytest

from portbench import harness

NEW = ["cnn_stage_ms", "cnn_h2d_ms", "kv_write_ms.serve", "kv_write_ms.open",
       "decode_attn_ms.serve", "decode_attn_ms.open", "engine_host_ms.serve",
       "engine_host_ms.open", "bwd_xg_ms.train", "bin_sums_ms.train"]
WANT = {"cnn_stage_ms": 25.0, "cnn_h2d_ms": 5.5, "kv_write_ms": 40.0, "decode_attn_ms": 120.0,
        "engine_host_ms": 35.0, "bwd_xg_ms": 30.0, "bin_sums_ms": 45.0}


def _rec(i, name, parent, t0, t1, device_ms=None):
    return SimpleNamespace(id=i, name=name, parent=parent, t0=t0, t1=t1, attrs={},
                           host_ms=1e3 * (t1 - t0), device_ms=device_ms)


def _records():
    """Two engine ticks (300 and 200 ms; their own host work 30 and 40 ms),
    three staged chunks, two train steps, and a tick past the window."""
    r = [
        _rec(1, "engine.step", None, 11.0, 11.3),
        _rec(2, "engine.prefill", 1, 11.01, 11.11, 90.0),
        _rec(3, "attn.kv_write", 2, 11.02, 11.03, 5.0),  # a prefill's: left out
        _rec(4, "engine.readback", 1, 11.11, 11.12),
        _rec(5, "engine.decode", 1, 11.12, 11.27, 140.0),
        _rec(6, "attn.kv_write", 5, 11.13, 11.14, 20.0),
        _rec(7, "attn.decode", 5, 11.14, 11.15, 60.0),
        _rec(8, "attn.kv_write", 5, 11.15, 11.16, 20.0),
        _rec(9, "attn.decode", 5, 11.16, 11.17, 60.0),
        _rec(10, "engine.readback", 1, 11.27, 11.28),
        _rec(11, "engine.step", None, 12.0, 12.2),
        _rec(12, "engine.decode", 11, 12.0, 12.15, 140.0),
        _rec(13, "attn.kv_write", 12, 12.01, 12.02, 20.0),
        _rec(14, "attn.decode", 12, 12.02, 12.03, 60.0),
        _rec(15, "attn.kv_write", 12, 12.03, 12.04, 20.0),
        _rec(16, "attn.decode", 12, 12.04, 12.05, 60.0),
        _rec(17, "engine.readback", 11, 12.15, 12.16),
        _rec(20, "batcher.stage", None, 13.0, 13.02),
        _rec(21, "batcher.h2d", None, 13.02, 13.03, 5.0),
        _rec(22, "batcher.stage", None, 13.1, 13.13),
        _rec(23, "batcher.h2d", None, 13.13, 13.14, 6.0),
        _rec(30, "train.step", None, 14.0, 15.0),
        _rec(40, "train.step", None, 15.0, 16.0),
    ]
    for step, t in ((30, 14.5), (40, 15.5)):
        for k in range(3):
            r.append(_rec(step + 1 + k, "pasm.bwd_xg", step, t, t + 0.01, 10.0))
            r.append(_rec(step + 4 + k, "pasm.bin_sums", step, t + 0.01, t + 0.02, 15.0))
    r += [_rec(90, "engine.step", None, 25.0, 25.5),
          _rec(91, "engine.decode", 90, 25.0, 25.4, 900.0),
          _rec(92, "attn.kv_write", 91, 25.0, 25.1, 1000.0),
          _rec(93, "batcher.stage", None, 9.0, 9.5),
          _rec(94, "train.step", None, 19.0, 21.0)]
    return r


def _run(profile=None):
    return SimpleNamespace(profile=profile, state={})


@pytest.fixture
def taken(monkeypatch):
    from repro_torch import trace

    recs = []
    monkeypatch.setattr(trace, "take", lambda: list(recs))
    return recs


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_its_per_tick_value(taken, name):
    taken.extend(_records())
    run = _run({"host_t0": 10.0, "host_t1": 20.0})
    assert harness._reader(name)(run) == pytest.approx(WANT[name.split(".")[0]])


def test_a_prefills_cache_write_is_left_out_and_the_window_bounds_the_records(taken):
    taken.extend(_records())
    read = harness._reader("kv_write_ms.serve")
    assert read(_run({"host_t0": 10.0, "host_t1": 30.0})) == pytest.approx(
        (80.0 + 1000.0) / 3)  # the third tick in the window now
    assert read(_run({"host_t0": 24.0, "host_t1": 30.0})) == pytest.approx(1000.0)
    assert read(_run({"host_t0": 0.0, "host_t1": 10.0})) is None


@pytest.mark.parametrize("name", NEW)
def test_no_records_read_none(taken, name, monkeypatch):
    assert harness._reader(name)(_run({"host_t0": 10.0, "host_t1": 20.0})) is None
    taken.extend(_records())
    assert harness._reader(name)(_run()) is None  # an untraced run
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)  # no recorder
    monkeypatch.delattr("repro_torch.trace", raising=False)
    assert harness._reader(name)(_run({"host_t0": 10.0, "host_t1": 20.0})) is None


def test_the_records_are_taken_from_the_program_once_a_run(taken):
    taken.extend(_records())
    run = _run({"host_t0": 10.0, "host_t1": 20.0})
    got = [harness._reader(n)(run) for n in NEW]
    taken.clear()  # what a second take() would find
    assert [harness._reader(n)(run) for n in NEW] == got


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.gpu
def test_program_spans_are_no_device_work_and_time_their_kernels(card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import trace

    a = torch.randn(4096, 4096, device=card)
    for _ in range(3):
        a @ a
    torch.cuda.synchronize()
    trace.take()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with record_function("portbench.window"):
            t0 = time.perf_counter()
            with trace.span("attn.decode", device=True):
                a @ a
            torch.cuda.synchronize()
            t1 = time.perf_counter()
    p = harness.summarize(prof, t0, t1)
    r, = trace.take()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "repro_torch.attn.decode" in names
    assert not any(n.startswith("repro_torch.") for n in p["kernel_s"])
    kernel_ms = 1e3 * sum(p["kernel_s"].values())
    assert kernel_ms > 1.0 and r.device_ms >= kernel_ms - 0.01, (r.device_ms, p["kernel_s"])
    assert r.device_ms <= 1e3 * (t1 - t0)
