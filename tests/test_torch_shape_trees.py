"""Shape-only trees and what the dry run counts on them, on the CPU.

* ``init_params(..., device="meta")`` and ``quantize_params`` on a meta
  tree (``PasmParams.quantize`` of a meta matrix) equal the real
  ``init_params`` plus ``quantize_params`` leaf for leaf, in shape, dtype
  and container metadata (kind, logical shape, bins, the §3 ``pad_k``), on
  every family's smoke config, and the CNN's ``init_params`` likewise.
* The dry run's FLOPs at a smoke size equal ``FlopCounterMode`` over the
  same step run on real CPU tensors: a quantized prefill and decode step,
  and a train step.
"""
import dataclasses

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_cnn_config, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.params import PasmParams
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as M
from repro_torch.models import api, cnn
from repro_torch.models.common import ShardCtx, quantize_params
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from repro_torch.tree import flatten_with_path

FAMILIES = ["qwen3-32b", "deepseek-moe-16b", "internvl2-26b", "mamba2-130m",
            "recurrentgemma-2b", "whisper-tiny"]


def _meta_of(tree) -> list:
    """Every leaf's path, shape and dtype, and every container's metadata."""
    out = [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_path(tree)]

    def walk(node, path=()):
        if isinstance(node, PasmParams):
            out.append((path, node.kind, node.shape, node.bins, node.pad_k))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (i,))

    walk(tree)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_shape_only_tree_equals_the_real_one(arch):
    cfg = get_config(arch, smoke=True).with_quant(enabled=True, min_weight_elems=1024)
    model = api.get_model(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        real = quantize_params(model.init_params(cfg, torch.Generator().manual_seed(0),
                                                 dtype), cfg, iters=1)
        meta = quantize_params(model.init_params(cfg, None, dtype, device="meta"), cfg)
        assert all(t.is_meta for _, t in flatten_with_path(meta))
        assert _meta_of(meta) == _meta_of(real)
        assert any(isinstance(x, PasmParams) and x.kind == "packed"
                   for x in _containers(meta))


def _containers(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _containers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _containers(v)
    else:
        yield tree


def test_cnn_shape_only_tree_equals_the_real_one():
    cfg = get_cnn_config("alexnet", smoke=True)
    real = cnn.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    meta = cnn.init_params(cfg, None, device="meta")
    assert [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_path(meta)] == \
        [(p, tuple(t.shape), t.dtype) for p, t in flatten_with_path(real)]
    assert all(t.is_meta for _, t in flatten_with_path(meta))


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_dry_run_flops_equal_the_cpu_steps(kind):
    """The dry run at mesh (1, 1) on meta tensors, and the same step on real
    CPU tensors under ``FlopCounterMode``: the same FLOPs."""
    cfg = get_config("qwen3-32b", smoke=True)
    if kind != "train":
        cfg = cfg.with_quant(min_weight_elems=1024)
    shape = ShapeSpec(f"{kind}_smoke", 16, 2, kind)
    mesh = M.make_conv_mesh((1, 1), device="meta")
    rep = dryrun.lower_cell(cfg, shape, mesh=mesh, verbose=False)["report"]
    assert rep.mesh == "1x1" and rep.n_devices == 1 and rep.collective_bytes == 0
    assert rep.extra["argument_bytes_per_device"] == sum(
        rep.extra["argument_bytes_by_kind"].values())
    train = kind == "train"
    dtype = torch.float32 if train else torch.bfloat16
    cfg_used = cfg if train else cfg.with_quant(enabled=True, impl="dequant")
    model = api.get_model(cfg_used)
    params = model.init_params(cfg_used, torch.Generator().manual_seed(0), dtype)
    if not train:
        params = quantize_params(params, cfg_used, iters=1)
    toks = torch.randint(0, cfg.vocab, (2, 1 if kind == "decode" else 16), dtype=torch.int32)
    sctx = ShardCtx.for_mesh(M.make_conv_mesh((1, 1), device="cpu"), 2)  # the dry run's
    with FlopCounterMode(display=False) as f:
        if train:
            step = tstep.make_train_step(cfg_used, opt.AdamWConfig(), sctx)
            step(params, opt.init_opt_state(params, mesh=sctx.mesh),
                 {"tokens": toks, "labels": toks})
        else:
            caches = model.init_caches(cfg_used, 2, 16, device="cpu")
            with torch.no_grad():
                fn = model.prefill if kind == "prefill" else model.decode_step
                fn(params, toks, caches, cfg_used, sctx)
    assert rep.flops_per_device == f.get_total_flops() > 0
    assert dataclasses.asdict(rep)["extra"]["quant"] == ("dense" if train else "pasm")
