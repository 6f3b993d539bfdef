"""The plain reference against the port's plain path at the smoke sizes,
from the same drawn weights, and the controls: the reference one precision
below the configuration's comes out worse than the program by the margin
the limits are set in."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.drivers import cnn_closed, lm_serve  # noqa: F401
from portbench.reference import cnn as ref_cnn
from portbench.reference import draw
from portbench.reference import lm as ref_lm
from portbench.reference.precision import fp8, tf32
from portbench.tests import smoke

SEED = 2**32 + 3


def _cfg(name):
    cfg = harness._json(harness.HERE / "configs" / f"{name}.json")
    return dict(cfg, **cfg["smoke"])


def test_the_cnn_reference_is_the_ports_stack():
    from repro_torch.models import cnn

    cfg = _cfg("alexnet")
    x = torch.from_numpy(draw.images(SEED, 6, cfg["in_chw"]))
    got = cnn.forward(cnn_closed.port_params(cfg, SEED, "cpu"), x, cnn_closed.port_config(cfg))
    want = ref_cnn.forward(cfg, ref_cnn.weights(cfg, SEED, "cpu"), x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


def test_the_lm_reference_is_the_ports_transformer(monkeypatch):
    from repro_torch.models import transformer

    # the port's activations in f32 (its module's one dtype switch), so the
    # two agree to f32 rounding
    monkeypatch.setattr(transformer, "_ACT", torch.float32)
    cfg = _cfg("phi3-medium-14b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg["vocab"], (1, 24)))
    pcfg = lm_serve.port_config(cfg)
    with torch.no_grad():
        got = transformer.forward(lm_serve.port_params(cfg, SEED, "cpu"), toks, pcfg)[0][0]
    want = ref_lm.logits_at(cfg, SEED, [toks[0]], [torch.arange(24)], "cpu")[0]
    assert float((got.float() - want).abs().max() / want.abs().max()) < 1e-4


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10 + 2**-12, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0])
    assert tf32(x).tolist() == [1.0 + 2**-10, 1.0, 1.0 + 2**-9, -3.0]
    y = torch.randn(1000)
    assert float((fp8(y) - y).abs().max()) < 0.07 * float(y.abs().max())


@pytest.mark.parametrize("workload", smoke.cells("cnn_closed") + smoke.cells("lm_serve")
                         + smoke.cells("lm_train"))
def test_the_control_fails_where_the_program_passes(workload):
    import importlib

    from portbench.limits import CONTROL
    from portbench.reference.precision import ROUNDINGS

    c, cfg, mix, limits = smoke.cell(workload)
    run = harness.Run(c, cfg, mix, limits, SEED, 0.3, False, torch.device("cpu"))
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    torch.set_num_threads(2)
    driver.setup(run)
    driver.window(run)
    driver.free(run)
    prog = {k: v["value"] for k, v in driver.check(run).items() if k in limits}
    ctrl = driver.control(run, ROUNDINGS[CONTROL[cfg["dtype"]]])
    ctrl = ctrl if isinstance(ctrl, dict) else {next(iter(limits)): ctrl}
    # at smoke size the control reads three times the program or more on one
    # of the cell's numbers; at the cell's size the gpu test holds it to the limit
    assert any(ctrl[k] > 0 and ctrl[k] >= 3 * prog[k] for k in prog), (prog, ctrl)
