"""A closed loop's pre-roll is counted in engine ticks: every run opens its
window in the same state, however slow the host is in one of them, so the
window's work does not shift with the host's timing."""
import time

import pytest
import torch

from portbench import harness
from portbench.drivers import lm_serve
from portbench.tests import smoke


def _calls_before_the_window(monkeypatch, delay: float) -> tuple:
    from repro_torch.serve.engine import Engine

    step = Engine.step

    def slow(self):
        time.sleep(delay)
        return step(self)

    monkeypatch.setattr(Engine, "step", slow)
    workload = smoke.cells("lm_serve")[0]
    c, cfg, mix, limits = smoke.cell(workload)
    assert mix["loop"] == "closed"
    run = harness.Run(c, cfg, mix, limits, 2**31 + 21, 0.3, False, torch.device("cpu"),
                      time.perf_counter())
    lm_serve.setup(run)
    lm_serve.window(run)
    before = [(s[3]["n"], s[3]["rows"]) for s in run.spans.items
              if s[0] == "prefill" and s[2] <= run.t0]
    decodes = sum(s[0] == "decode" and s[2] <= run.t0 for s in run.spans.items)
    return before, decodes, mix["preroll_ticks"]


@pytest.mark.parametrize("delay", [0.0, 0.02])
def test_a_closed_loop_opens_its_window_in_the_same_state(monkeypatch, delay):
    torch.set_num_threads(2)
    with monkeypatch.context() as m:
        fast = _calls_before_the_window(m, 0.0)
    with monkeypatch.context() as m:
        slow = _calls_before_the_window(m, delay)
    assert fast == slow
    prefills, decodes, ticks = fast
    assert decodes == ticks and len(prefills) >= smoke.cell(smoke.cells("lm_serve")[0])[2]["clients"]
