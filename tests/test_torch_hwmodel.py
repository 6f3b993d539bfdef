"""The port's analytical hardware model equals the JAX package's exactly.

``repro_torch.core.hwmodel`` is a copy of ``repro.core.hwmodel`` (its HBM
traffic terms are held in ``tests/test_torch_roofline.py``); every figure
must be ``==`` the JAX one (both are
pure Python floats), over the widths and dictionary sizes the paper uses.
"""
import dataclasses

import pytest

from repro.core import hwmodel as jhw
from repro_torch.core import hwmodel as thw

WIDTHS = (4, 8, 16, 32)
BINS = (4, 8, 16, 64, 256)


@pytest.mark.parametrize("B", BINS)
@pytest.mark.parametrize("W", WIDTHS)
def test_unit_gate_power_and_latency_equal(W, B):
    for name in ("mac_unit",):
        assert dataclasses.astuple(getattr(thw, name)(W)) == \
            dataclasses.astuple(getattr(jhw, name)(W))
    for name in ("weight_shared_mac_unit", "pas_unit", "accel_16mac", "accel_16pas4mac"):
        t, j = getattr(thw, name)(W, B), getattr(jhw, name)(W, B)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        assert (t.inverters(), t.buffers(), t.total()) == \
            (j.inverters(), j.buffers(), j.total())
    assert thw.gate_ratio(W, B) == jhw.gate_ratio(W, B)
    assert thw.power_model(W, B) == jhw.power_model(W, B)
    for w in (8, 32):  # the calibrated widths
        assert thw.accel_ratio_asic(B, W=w) == jhw.accel_ratio_asic(B, W=w)
    if W not in (8, 32):
        with pytest.raises(ValueError):
            thw.accel_ratio_asic(B, W=W)
        with pytest.raises(ValueError):
            jhw.accel_ratio_asic(B, W=W)
    assert thw.accel_ratio_fpga(B) == jhw.accel_ratio_fpga(B)
    for pasm in (True, False):
        assert thw.fpga_resources(B, W, pasm=pasm) == jhw.fpga_resources(B, W, pasm=pasm)
    assert thw.conv_latency_ratio(B) == jhw.conv_latency_ratio(B)
    conv = dict(IH=13 + W, IW=11 + W, C=W, KY=3, KX=5, M=2, stride=1 + W % 3)
    for pm in (1, 2, 4):
        assert thw.conv_latency_cycles(**conv, bins=B, postpass_mults=pm) == \
            jhw.conv_latency_cycles(**conv, bins=B, postpass_mults=pm)
    assert thw.conv_latency_cycles(**conv) == jhw.conv_latency_cycles(**conv)


def test_paper_claims_and_constants_identical():
    assert thw.PAPER_CLAIMS == jhw.PAPER_CLAIMS
    assert list(thw.PAPER_CLAIMS) == list(jhw.PAPER_CLAIMS)
    assert thw.PAPER_CONV == jhw.PAPER_CONV
    assert dataclasses.astuple(thw.GateConstants()) == dataclasses.astuple(jhw.GateConstants())
    assert thw._ACT == jhw._ACT and thw._LEAK == jhw._LEAK
    for ky, kx, s in [(11, 11, 4), (5, 5, 1), (3, 3, 1), (3, 3, 2)]:
        assert thw.im2col_inflation(ky, kx, s) == jhw.im2col_inflation(ky, kx, s)
    # every name, the traffic terms included (tests/test_torch_roofline.py)
    assert set(jhw.__all__) == set(thw.__all__)
    assert thw.conv_latency_cycles(**thw.PAPER_CONV) == \
        jhw.conv_latency_cycles(**jhw.PAPER_CONV)
