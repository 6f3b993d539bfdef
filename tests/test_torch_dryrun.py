"""The port's dry run at the production mesh, on the CPU.

``python -m repro_torch.launch.dryrun`` counts rank 0's own step at 16×16
on meta tensors under a fake process group of 256 ranks.  For
qwen3-32b × decode_32k, mamba2-130m × train_4k, stablelm-3b × train_4k and
qwen3-32b × train_4k it finishes, writes the cell's JSON, and its per-device param bytes equal
the sum over ``param_pspecs``' blocks (each leaf's bytes over the mesh
axes its spec names); the step's terms are positive and name a
bottleneck.  A train cell's step holds no global ``(batch, seq, vocab)``
logits (the loss runs on a rank's block), no attention tensor over every
q head (a rank runs its block of them, ``models/common.py::head_block``),
and fits the H100's 80 GB.  The spec rules' meta stand-ins are not
counted.
"""
import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch import roofline
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh
from repro_torch.models import api, sharding
from repro_torch.models.common import quantize_params
from repro_torch.tree import tree_map

SIZES = {"data": 16, "model": 16}


def _spec_block_bytes(tree) -> int:
    specs = sharding.param_pspecs(tree, SIZES)
    out = []

    def one(t, spec):
        n = 1
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
                n *= SIZES[a]
        assert t.numel() % n == 0
        out.append(t.numel() // n * t.element_size())

    tree_map(one, tree, specs)
    return sum(out)


@pytest.mark.parametrize("arch,shape", [("qwen3-32b", "decode_32k"),
                                        ("mamba2-130m", "train_4k"),
                                        ("stablelm-3b", "train_4k"),
                                        ("qwen3-32b", "train_4k")])
def test_dry_run_at_16x16(arch, shape, tmp_path):
    dryrun.main(["--arch", arch, "--shape", shape, "--out", str(tmp_path)])
    assert not dist.is_initialized()  # the fake world is torn down
    (f,) = tmp_path.glob("*.json")
    assert f.name == f"{arch}_{shape}_16x16_auto.json"
    rep = json.loads(f.read_text())
    cfg, spec = get_config(arch), SHAPES[shape]
    train = spec.kind == "train"
    dtype = torch.float32 if train else torch.bfloat16  # the dry run's
    params = api.get_model(cfg).init_params(cfg, None, dtype, device="meta")
    if not train:
        params = quantize_params(params, cfg.with_quant(enabled=True, impl="dequant"))
    assert rep["extra"]["argument_bytes_by_kind"]["params"] == _spec_block_bytes(params)
    assert rep["extra"]["quant"] == ("dense" if train else "pasm")
    assert rep["n_devices"] == 256 and rep["mesh"] == "16x16"
    assert rep["flops_per_device"] > 0 and rep["bytes_per_device"] > 0
    assert rep["collective_bytes"] > 0 and rep["collectives"]["counts"]
    assert rep["bottleneck"] in ("compute", "memory", "collective")
    terms = {"compute": rep["compute_s"], "memory": rep["memory_s"],
             "collective": rep["collective_s"]}
    assert rep["bottleneck"] == max(terms, key=terms.get)
    assert math.isclose(rep["compute_s"], rep["flops_per_device"] / 989e12)
    assert rep["extra"]["peak_live_bytes_per_device"] > rep["extra"]["argument_bytes_per_device"]
    if train:
        logits = spec.global_batch * spec.seq_len * cfg.vocab
        assert all(math.prod(dims) < logits for _, _, dims in rep["extra"]["biggest_tensors"])
        assert rep["extra"]["fits"], rep["extra"]["peak_live_bytes_per_device"]
        # no attention tensor over every head: a rank's block of the q heads
        # (qwen3's 64 over model 16: 4) scores its rows' chunks
        rows = spec.global_batch // SIZES["data"] * spec.seq_len * min(cfg.attn_chunk,
                                                                       spec.seq_len)
        assert not cfg.n_heads or all(math.prod(dims) < rows * cfg.n_heads
                                      for _, _, dims in rep["extra"]["biggest_tensors"])


def test_spec_stand_ins_are_not_counted():
    """The shape-only meta tensors the train step's spec rules build (the
    global tree behind a placed one, JAX's stacked shapes for ZeRO-1) hold
    no storage on any device: the dry run's counter sees none of them."""
    cfg = get_config("stablelm-3b", smoke=True)
    params = api.get_model(cfg).init_params(cfg, None, torch.float32, device="meta")
    mesh = Mesh((2, 2), ("data", "model"), (0, 0), (None, None), torch.device("meta"))
    placed = sharding.place_params(params, mesh)
    counter = roofline.StepCounter()
    with counter:
        specs = sharding.placed_specs(placed, mesh)
        dims = sharding.zero_dims(placed, mesh, specs)
        sharding.global_like(placed, mesh, specs)
    assert dims and counter.peak_bytes == 0 and counter.nbytes == 0
