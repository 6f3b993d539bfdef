"""On the card (``python -m pytest -m gpu portbench/tests``): each cell's
output check at its own size on one seed, the program inside its limit
and the control outside it.  Skips without a card."""
import pytest

from portbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [c["name"] for c in harness.manifest()["workloads"]])
def test_the_program_passes_and_the_control_fails_at_the_cells_size(card, workload):
    from portbench.limits import readings

    cell, cfg, mix, limits = harness.load_cell(harness.manifest(), workload)
    r = readings(cell, cfg, mix, limits, 2**31 + 77, 40.0, card, control=True)
    assert all(c["value"] <= c["limit"] for c in r["checks"].values()), r
    ctrl = r["control"] if isinstance(r["control"], dict) else {next(iter(limits)): r["control"]}
    assert any(v > limits[k] for k, v in ctrl.items() if k in limits), r
