"""Dry run of the port: every (arch × shape) cell's step on the production
mesh, counted without computing, with its memory fit and roofline terms.

Port of ``repro.launch.dryrun``.  The JAX package lowers and compiles each
cell for 512 placeholder devices and reads the executable's cost and memory
analysis.  The port has no compiled program, so it runs rank 0's own SPMD
step on ``meta`` tensors (shapes and dtypes, no storage) under
``torch.distributed``'s ``fake`` process group, whose world is the mesh's
size: the step builds the mesh, places its params and caches as every rank
does (``models/sharding.py``), and runs its collectives, which move nothing.
:class:`repro_torch.roofline.StepCounter` counts what that step does.  Per
cell and per device it reports:

* argument bytes — params by ``param_pspecs`` (``opt_state_pspecs`` with
  ``--fsdp``), the AdamW moments by ``opt_state_pspecs`` (JAX's ZeRO-1),
  caches by ``cache_pspecs``, inputs by ``input_pspecs``, each leaf's block
  over the mesh's axis sizes — the same on every device;
* rank 0's own step: its FLOPs, the bytes its ops read and write, the peak
  of the live bytes it allocates (added to the argument bytes), and its
  collectives' result bytes, ring-weighted (``roofline.collective_stats``);
* the roofline terms on the H100's rates, the bottleneck and
  ``roofline_fraction``, ``model_flops`` as the JAX package computes it
  (6·N·D for training, 2·N·D otherwise);
* the fit against the H100's 80 GB (the card's specification, not a
  measurement).

The step runs ``impl="dequant"``, as the JAX dry run does: the kernels are
ctypes launches that no dispatch mode sees.  The port's per-layer lists run
every layer, so there is no scan correction (JAX's ``--no-scan-correction``
has nothing to turn off).  What is modelled rather than counted: ``--fsdp``
changes the param bytes only (the port has no ZeRO-3 step, so the step's
terms are the ZeRO-1 step's); the port's models shard the batch over one
``data`` axis, so the 2×16×16 mesh runs as (pod·data, model) = 32×16, and
its moments split over 32 ranks where JAX's split over ``data``'s 16.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Union

import torch
import torch.distributed as dist

from repro_torch import roofline as RL
from repro_torch.configs import SHAPES, all_cells, cell_supported, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.launch import mesh as M
from repro_torch.models import api, sharding
from repro_torch.models.common import ShardCtx, quantize_params
from repro_torch.train import optimizer as opt
from repro_torch.train import step as train_step_mod
from repro_torch.tree import tree_map

__all__ = ["lower_cell", "main", "DEFAULT_OUT"]

DEFAULT_OUT = Path("experiments/dryrun_torch")


@contextlib.contextmanager
def fake_world(n: int):
    """A ``fake`` process group of ``n`` ranks, this process rank 0, for
    the body: collectives run and move nothing.  One rank needs no group."""
    if n == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the dry run "
                           "runs rank 0 of its own fake world")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_shape(multi_pod: bool) -> tuple:
    """The ``(data, model)`` mesh a production cell runs on: 16×16, and the
    2×16×16 mesh as (pod·data, model)."""
    if multi_pod:
        pod, data, model = M.MULTI_POD
        return pod * data, model
    return M.SINGLE_POD


def _abstract_params(cfg: ArchConfig, dtype, quant: str, kv_bits: int = 16):
    """The cell's params as ``meta`` tensors, quantized for ``pasm``."""
    model = api.get_model(cfg)
    if quant != "dense":
        cfg = cfg.with_quant(enabled=True, impl="dequant", kv_bits=kv_bits)
        return quantize_params(model.init_params(cfg, None, dtype, device="meta"), cfg), cfg
    return model.init_params(cfg, None, dtype, device="meta"), cfg


def _blocks(spec, sizes: dict, shape) -> int:
    """Elements of one device's block of ``shape`` under ``spec``."""
    n = 1
    for i, d in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        k = 1
        for a in (ax if isinstance(ax, tuple) else (ax,) if ax else ()):
            k *= sizes.get(a, 1)
        n *= -(-int(d) // k)
    return n


def block_bytes(tree, specs, sizes: dict, itemsize=None) -> int:
    """One device's bytes of ``tree`` placed by the spec tree ``specs``
    over ``sizes`` (``itemsize``: the moments' f32 in place of the leaf's,
    a 0-d placeholder for an integer leaf)."""
    out = []

    def one(t, s):
        if itemsize is not None and not t.is_floating_point():
            out.append(itemsize)
        else:
            out.append(_blocks(s, sizes, t.shape) * (itemsize or t.element_size()))

    tree_map(one, tree, specs)
    return sum(out)


def _resolve(arch: Union[str, ArchConfig], shape: Union[str, ShapeSpec]):
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    return cfg, shape


def _count_step(cfg, shape, mesh, quant, *, fsdp, microbatches, remat, kv_bits) -> dict:
    """Argument bytes by spec, then rank 0's step on ``mesh`` counted."""
    sizes = M.axis_sizes(mesh)
    train = shape.kind == "train"
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    dtype = torch.float32 if train else torch.bfloat16
    params, cfg_used = _abstract_params(cfg, dtype, quant, kv_bits)
    model = api.get_model(cfg_used)
    sctx = ShardCtx.for_mesh(mesh, shape.global_batch)
    specs = api.input_specs(cfg_used, shape)
    p_specs = sharding.param_pspecs(params, sizes)
    args = {"params": block_bytes(params, sharding.opt_state_pspecs(params, p_specs, sizes)
                                  if fsdp else p_specs, sizes),
            "inputs": block_bytes(specs, sharding.input_pspecs(specs, sctx.batch), sizes)}
    placed = sharding.place_params(params, mesh)
    counter = RL.StepCounter()
    M.reset_collective_bytes()
    if train:
        z_specs = sharding.opt_state_pspecs(params, p_specs, sizes)
        args["moments"] = 2 * block_bytes(params, z_specs, sizes, itemsize=4) + 4
        state = opt.init_opt_state(placed, mesh=mesh)
        step = train_step_mod.make_train_step(cfg_used, opt.AdamWConfig(), sctx,
                                              microbatches=microbatches)
        t0 = time.perf_counter()
        with counter:
            step(placed, state, specs)
    else:
        caches = model.init_caches(cfg_used, shape.global_batch,
                                   api.cache_len(cfg_used, shape), device="meta")
        args["caches"] = block_bytes(caches, sharding.cache_pspecs(cfg_used, caches, sizes,
                                                                   sctx.batch), sizes)
        caches = sharding.place_caches(cfg_used, caches, mesh, sctx.batch)
        t0 = time.perf_counter()
        with counter, torch.no_grad():
            if shape.kind == "prefill":
                kw = {k: v for k, v in specs.items() if k == "frontend_embeds"}
                model.prefill(placed, specs["tokens"], caches, cfg_used, sctx, **kw)
            else:
                model.decode_step(placed, specs["tokens"], caches, cfg_used, sctx)
    return {"cfg": cfg_used, "args": args, "counter": counter,
            "collectives": RL.collective_stats(dict(M.collective_ops)),
            "collective_keys": {k: v for k, v in M.collective_bytes.items() if v},
            "step_s": time.perf_counter() - t0}


def lower_cell(
    arch: Union[str, ArchConfig],
    shape: Union[str, ShapeSpec],
    *,
    multi_pod: bool = False,
    quant: str = "auto",
    mesh=None,
    verbose: bool = True,
    fsdp: bool = False,
    microbatches: int = 1,
    remat: bool | None = None,
    kv_bits: int = 16,
):
    """Count one cell (names, or an ``ArchConfig`` and a ``ShapeSpec``).

    ``mesh``: a ``("data", "model")`` mesh of the caller's world to run on
    (its device ``meta``); by default the production mesh in a fake world of
    its size.  Returns ``{"arch", "shape", "status", "report"}``."""
    cfg, shape = _resolve(arch, shape)
    hw = RL.HW()
    name = arch if isinstance(arch, str) else cfg.name
    if isinstance(arch, str):
        ok, why = cell_supported(arch, shape.name)
        if not ok:
            return {"arch": name, "shape": shape.name, "status": "skipped", "reason": why}
    if quant == "auto":
        # the paper is inference-focused: PASM on serve cells, dense training
        quant = "dense" if shape.kind == "train" else "pasm"
    t0 = time.perf_counter()
    kw = dict(fsdp=fsdp, microbatches=microbatches, remat=remat, kv_bits=kv_bits)
    if mesh is None:
        mshape = production_shape(multi_pod)
        with fake_world(math.prod(mshape)):
            got = _count_step(cfg, shape, M.make_conv_mesh(mshape, device="meta"), quant, **kw)
    else:
        mshape = mesh.shape
        got = _count_step(cfg, shape, mesh, quant, **kw)
    n_dev = math.prod(mshape)
    mesh_name = "2x16x16" if multi_pod and mesh is None else "x".join(map(str, mshape))
    counter, args = got["counter"], got["args"]
    arg_bytes = sum(args.values())
    n_params = cfg.n_active_params() if cfg.moe else cfg.n_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6.0 if shape.kind == "train" else 2.0) * n_params * tokens
    peak = arg_bytes + counter.peak_bytes
    report = RL.roofline_terms(
        arch=name, shape=shape.name, mesh_name=mesh_name, n_devices=n_dev,
        flops=counter.flops, nbytes=counter.nbytes, collectives=got["collectives"],
        model_flops=model_flops,
        extra={
            "quant": quant,
            "mesh_run": "x".join(map(str, mshape)),
            "argument_bytes_per_device": arg_bytes,
            "argument_bytes_by_kind": args,
            "peak_live_bytes_per_device": peak,
            "hbm_fraction_of_spec": peak / hw.hbm_bytes,
            "fits": peak <= hw.hbm_bytes,
            "collective_bytes_by_key": got["collective_keys"],
            "bytes_by_op": counter.op_bytes_by_kind(8),
            "biggest_tensors": counter.biggest_tensors(4),
            "rank0_own": ["flops_per_device", "bytes_per_device", "collective_bytes",
                          "peak_live_bytes_per_device (its temporaries)"],
            "modelled": ["argument_bytes_per_device (by spec)"]
            + (["fsdp: param bytes only"] if fsdp else [])
            + (["2x16x16 run as 32x16: moments over 32 data ranks"] if mesh_name == "2x16x16"
               else []),
            "fsdp": fsdp,
            "microbatches": microbatches,
            "step_s": round(got["step_s"], 3),
            "cell_s": round(time.perf_counter() - t0, 3),
        },
    )
    if verbose:
        print(f"--- {name} × {shape.name} × {mesh_name} (quant={quant}) ---")
        print(f"  args {arg_bytes / 2**30:.2f} GiB/dev + temp peak "
              f"{counter.peak_bytes / 2**30:.2f} GiB/dev = {peak / hw.hbm_bytes * 100:.0f}% "
              f"of the H100's 80 GB (spec)")
        print(f"  flops/dev {report.flops_per_device:.3e}  bytes/dev "
              f"{report.bytes_per_device:.3e}  coll B/dev {report.collective_bytes:.3e}")
        print(f"  terms: compute {report.compute_s * 1e3:.2f} ms | memory "
              f"{report.memory_s * 1e3:.2f} ms | collective {report.collective_s * 1e3:.2f} ms"
              f" → {report.bottleneck}-bound; useful-flops {report.useful_flops_frac:.2f}, "
              f"roofline frac {report.roofline_fraction:.3f}")
        print(f"  counted in {report.extra['cell_s']:.1f} s (CPU, meta tensors)")
    return {"arch": name, "shape": shape.name, "status": "ok", "report": report}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant", default="auto", choices=["auto", "dense", "pasm"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="default", choices=["default", "on", "off"])
    ap.add_argument("--kv-bits", type=int, default=16, choices=[8, 16])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    if args.all:
        cells = [(a, s) for a, s, _, _ in all_cells()]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape (or --all)")

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    t0 = time.perf_counter()
    for mp in meshes:
        for arch, shape in cells:
            tag = (f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}_{args.quant}"
                   + ("_fsdp" if args.fsdp else ""))
            try:
                res = lower_cell(
                    arch, shape, multi_pod=mp, quant=args.quant, fsdp=args.fsdp,
                    microbatches=args.microbatches,
                    remat=None if args.remat == "default" else args.remat == "on",
                    kv_bits=args.kv_bits,
                )
            except Exception as e:  # noqa: BLE001 — one cell's failure is reported, the rest run
                traceback.print_exc()
                failures.append(tag)
                (out / f"{tag}.json").write_text(
                    json.dumps({"arch": arch, "shape": shape, "status": "error", "error": repr(e)}))
                continue
            if res["status"] == "ok":
                (out / f"{tag}.json").write_text(res["report"].to_json())
            else:
                (out / f"{tag}.json").write_text(json.dumps(res))
                print(f"--- {arch} × {shape}: SKIPPED ({res['reason']})")
    if failures:
        print(f"\nFAILED cells: {failures}")
        raise SystemExit(1)
    print(f"\nall requested cells counted OK in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
