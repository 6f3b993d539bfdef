"""The harness's output check, driven at smoke size on the CPU with the
chip's look skipped: a sound run comes out correct, and a run whose timed
path is broken underneath (an answer or a token altered where it is
produced) comes out not correct."""
import numpy as np
import pytest
import torch

from portbench.tests import smoke


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", smoke.cells("cnn_closed") + smoke.cells("lm_serve"))
def test_a_sound_run_is_correct(workload):
    res = smoke.run(workload, seed=2**31 + 11, seconds=0.6)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"


def test_an_altered_answer_is_caught(monkeypatch):
    from repro_torch.models import cnn

    forward = cnn.forward

    def altered(params, images, cfg, **kw):
        y = forward(params, images, cfg, **kw)
        y[0, 0] += 0.5 * y[0].abs().max()
        return y

    monkeypatch.setattr(cnn, "forward", altered)
    res = smoke.run(smoke.cells("cnn_closed")[0], seed=5, seconds=0.6)
    assert not res["correct"] and res["checks"]["logit_err"]["value"] > 0.1


@pytest.mark.parametrize("workload", smoke.cells("lm_serve"))
def test_an_altered_token_is_caught(monkeypatch, workload):
    from repro_torch.serve.engine import Engine

    guard = Engine._guard

    def altered(logits):
        nxt, ok = guard(logits)
        nxt = np.array(nxt)
        nxt[0] = (nxt[0] + 1) % logits.shape[-1]
        return nxt, ok

    monkeypatch.setattr(Engine, "_guard", staticmethod(altered))
    res = smoke.run(workload, seed=6, seconds=0.6)
    assert not res["correct"] and res["checks"]["token_gap"]["value"] > 0


def test_a_missing_answer_is_caught(monkeypatch):
    from repro_torch.serve.batcher import CnnBatcher

    flush = CnnBatcher.flush

    def drops(self):
        served = flush(self)
        if len(served) > 1:  # one answer never comes back to its client
            self.waiting.append(served.pop())
        return served

    monkeypatch.setattr(CnnBatcher, "flush", drops)
    res = smoke.run(smoke.cells("cnn_closed")[0], seed=8, seconds=0.6)
    assert not res["correct"] and res["checks"]["missing"]["value"] > 0


def test_a_training_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    from repro_torch.train import step as st

    def unchanged(*a, **kw):
        return lambda params, state, batch: (
            params, state, {"loss": torch.tensor(float(torch.log(torch.tensor(256.0))))})

    monkeypatch.setattr(st, "make_train_step", unchanged)
    for w in smoke.cells("lm_train"):
        res = smoke.run(w, seed=9, seconds=0.3)
        assert not res["correct"]
        assert res["checks"]["grad_err"]["value"] > 0.9
        assert res["checks"]["delta_err"]["value"] > 0.9


def test_a_training_step_on_half_the_batch_is_caught(monkeypatch):
    from repro_torch.train import step as st

    make = st.make_train_step

    def halved(*a, **kw):
        real = make(*a, **kw)

        def step(params, state, batch):
            n = batch["tokens"].shape[0] // 2
            return real(params, state, {k: v[:n] for k, v in batch.items()})

        return step

    monkeypatch.setattr(st, "make_train_step", halved)
    for w in smoke.cells("lm_train"):
        res = smoke.run(w, seed=10, seconds=0.3)
        assert not res["correct"], res["checks"]
