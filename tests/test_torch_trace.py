"""The port's span recorder (``repro_torch.trace``) and its sites, on the CPU.

Off, a span records nothing and makes no event.  On, under ``recording()``
or a profiler, each span carries its name, ordered host times, its
parent's id and its attributes, and under a profiler it is also one of the
profiler's events.  The sites record where the serving engine, the CNN
batcher and K1's backward do their work.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.configs import get_cnn_config, get_config
from repro_torch.kernels import ops
from repro_torch.models import api, cnn
from repro_torch.models.common import quantize_params
from repro_torch.serve.batcher import CnnBatcher
from repro_torch.serve.engine import Engine
from repro_torch.train import optimizer as opt
from repro_torch.train.step import make_train_step


@pytest.fixture(autouse=True)
def clean():
    trace.take()
    yield
    trace.take()


class _FakeEvent:
    """A timing event that reads the host clock, counting those made."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


@pytest.fixture
def events(monkeypatch):
    monkeypatch.setattr(_FakeEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(trace._REC, "pool", [])
    return _FakeEvent


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def _ancestors(r, by_id):
    names = []
    while r.parent is not None:
        r = by_id[r.parent]
        names.append(r.name)
    return names


def test_off_nothing_is_recorded_and_no_event_is_made(events):
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace.span("engine.step", tick=1) as rec:
        with trace.span("attn.kv_write", device=True):
            pass
    assert rec is None and trace.take() == [] and events.made == 0
    with trace.recording():  # on, the same device span makes its two events
        with trace.span("attn.kv_write", device=True):
            pass
    r, = trace.take()
    assert events.made == 2 and r.device_ms >= 0.0
    assert len(trace._REC.pool) == 2  # read once, the events go back to the pool
    with trace.recording():
        with trace.span("attn.kv_write", device=True):
            pass
    assert events.made == 2 and trace._REC.pool == []


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_nested_spans_carry_name_times_parent_and_attrs(how):
    prof = profile(activities=[ProfilerActivity.CPU]) if how == "profiler" else None
    with (prof if prof is not None else trace.recording()):
        with trace.span("engine.step", tick=7):
            with trace.span("engine.decode", rows=3):
                with trace.span("attn.decode"):
                    pass
            with trace.span("engine.readback"):
                pass
    recs = trace.take()
    assert trace.take() == []  # taken once
    r = {x.name: x for x in recs}
    assert set(r) == {"engine.step", "engine.decode", "attn.decode", "engine.readback"}
    assert r["engine.step"].parent is None
    assert r["engine.decode"].parent == r["engine.readback"].parent == r["engine.step"].id
    assert r["attn.decode"].parent == r["engine.decode"].id
    assert r["engine.step"].attrs == {"tick": 7} and r["engine.decode"].attrs == {"rows": 3}
    s, d, a, b = (r[n] for n in ("engine.step", "engine.decode", "attn.decode",
                                 "engine.readback"))
    assert s.t0 <= d.t0 <= a.t0 <= a.t1 <= d.t1 <= b.t0 <= b.t1 <= s.t1
    assert all(x.device_ms is None for x in recs)
    if prof is not None:
        names = {e.name for e in prof.events()}
        assert {f"repro_torch.{n}" for n in r} <= names


def test_a_span_on_another_thread_takes_the_open_span_as_its_parent():
    seen = []

    def work():
        with trace.span("pasm.bwd_xg"):
            with trace.span("pasm.bin_sums"):
                seen.append(threading.get_ident())

    with trace.recording():
        with trace.span("train.step"):
            t = threading.Thread(target=work)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive() and seen and seen[0] != threading.get_ident()
    r = {x.name: x for x in trace.take()}
    assert r["pasm.bwd_xg"].parent == r["train.step"].id
    assert r["pasm.bin_sums"].parent == r["pasm.bwd_xg"].id
    assert trace._REC.open == {}


def test_the_engine_records_its_ticks_calls_and_attention():
    cfg = get_config("stablelm-3b", smoke=True)
    params = api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    eng = Engine(cfg, params, batch_slots=2, max_seq=32)
    r = eng.submit(np.arange(5, dtype=np.int32), max_new=3)
    with trace.recording():
        eng.step()
        eng.step()
    recs = trace.take()
    by_id, n = {x.id: x for x in recs}, _by_name(recs)
    assert len(n["engine.step"]) == 2
    pre, = n["engine.prefill"]
    assert pre.attrs == {"uid": r.uid}  # ties the span to the request's Timeline
    assert _ancestors(pre, by_id) == ["engine.step"]
    assert [_ancestors(x, by_id) for x in n["engine.decode"]] == [["engine.step"]] * 2
    under = {}
    for x in n["attn.kv_write"] + n["attn.decode"]:
        under.setdefault(x.name, []).append(by_id[x.parent].name)
    layers = cfg.n_layers
    assert sorted(under["attn.kv_write"]) == ["engine.decode"] * 2 * layers + [
        "engine.prefill"] * layers
    assert under["attn.decode"] == ["engine.decode"] * 2 * layers
    assert all(_ancestors(x, by_id) == ["engine.step"] for x in n["engine.readback"])
    assert len(n["engine.readback"]) == 3  # the prefill's and two decodes'


def test_the_batcher_records_each_chunks_staging_and_copy():
    ccfg = get_cnn_config("alexnet", smoke=True)
    cparams = cnn.quantize(cnn.init_params(ccfg, torch.Generator().manual_seed(0),
                                           device="cpu"), ccfg)
    cb = CnnBatcher(ccfg, cparams, max_batch=2, device="cpu")
    C, H, W = ccfg.in_chw
    for _ in range(3):
        cb.submit(np.ones((C, H, W), np.float32))
    with trace.recording():
        done = cb.flush()
    assert len(done) == 3
    n = _by_name(trace.take())
    assert [x.attrs for x in n["batcher.stage"]] == [{"n": 2}, {"n": 1}]
    assert [x.attrs for x in n["batcher.h2d"]] == [{"n": 2}, {"n": 1}]
    assert all(x.device_ms is None for x in n["batcher.h2d"])  # a CPU copy


def test_the_pasm_backward_records_its_product_and_bin_sums():
    g = torch.Generator().manual_seed(0)
    M, K, N, G, B = 6, 16, 8, 2, 4
    x, gy = torch.randn(M, K, generator=g), torch.randn(M, N, generator=g)
    idx = torch.randint(0, B, (K, N), generator=g, dtype=torch.uint8)
    cb = torch.randn(G, B, generator=g)
    want = ops._pasm_bwd(x, idx, cb, False, gy, True, True)
    with trace.recording():
        got = ops._pasm_bwd(x, idx, cb, False, gy, True, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    r = {x.name: x for x in trace.take()}
    assert set(r) == {"pasm.bwd_xg", "pasm.bin_sums"}
    assert r["pasm.bwd_xg"].t1 <= r["pasm.bin_sums"].t0


def test_a_train_steps_backward_records_under_it():
    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    params = quantize_params(
        api.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    step = make_train_step(cfg, opt.AdamWConfig())
    toks = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator().manual_seed(1),
                         dtype=torch.int32)
    with trace.recording():
        step(params, opt.init_opt_state(params),
             {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    recs = trace.take()
    by_id, n = {x.id: x for x in recs}, _by_name(recs)
    top, = n["train.step"]
    assert n["pasm.bwd_xg"] and len(n["pasm.bwd_xg"]) == len(n["pasm.bin_sums"])
    assert all(_ancestors(x, by_id) == ["train.step"] for x in n["pasm.bwd_xg"])
    assert all(top.t0 <= x.t0 <= x.t1 <= top.t1 for x in recs)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.gpu
def test_only_a_decode_steps_cache_write_is_timed_on_the_device(card):
    from repro_torch.nn import attention as A

    cache = A.init_kv_cache(2, 16, 2, 8, torch.bfloat16, device=card)
    with trace.recording():
        for S in (4, 1):
            kv = torch.randn(2, S, 2, 8, device=card, dtype=torch.bfloat16)
            cache = A.update_cache(cache, kv, kv)
    torch.cuda.synchronize()
    prefill, decode = trace.take()
    assert prefill.device_ms is None and decode.device_ms >= 0.0


@pytest.mark.gpu
def test_chip_smokes_step_timer_counts_no_program_span_as_a_kernel(card):
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    a = torch.randn(2048, 2048, device=card)

    def bare():
        return a @ a

    def spanned():
        with trace.span("train.step"):
            with trace.span("attn.decode", device=True):
                return a @ a

    want, got = chip_smoke.time_step(bare), chip_smoke.time_step(spanned)
    trace.take()
    assert got["kernels"] == want["kernels"] > 0
    assert not any(n.startswith("repro_torch.") for n, _, _ in got["top"])
    assert got["device_ms"] < 2 * want["device_ms"]
