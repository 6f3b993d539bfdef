"""Training launcher: end-to-end driver with checkpoint/restart + supervision.

Port of ``repro.launch.train``, with the port's ``--device`` (default the
card)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-32b --smoke \\
        --steps 200 --ckpt-dir /tmp/ckpt --resume auto

The loop is ``train/loop.py::run_loop`` under ``ft.Supervisor``, run under
``train.step.deterministic()`` so a resumed run equals the uninterrupted
one bit for bit.  Every step carries the fused non-finite guard — a
NaN/inf batch skips its update bit-exactly and ``--guard-max-skip``
consecutive skips escalate to a restorable error; checkpoints are CRC32'd
and fsync'd, and restore falls back past a corrupt newest checkpoint to
the newest *valid* one; the supervisor classifies failures (the same step
failing the same way twice across a restore → fail fast as deterministic;
anything else → backoff restart threading the failure's ``resume_step``
hint); the data is step-addressed, and per-step wall times feed the
straggler detector every step.

Flags beyond the obvious:

``--quant pasm|qat``     weight-share the model (``pasm``: the K1 kernel
                         path, ``impl="kernel"``; ``qat``: ``dequant``)
``--guard-max-skip K``   escalate after K consecutive non-finite steps (3)
``--keep N``             checkpoint rotation depth (3)
``--max-restarts N``     supervisor restart budget (3)
``--faults-seed S``      chaos drill: run under a seeded
                         ``train.faults.TrainFaultPlan`` sampled from S
``--resume auto``        restore the newest checkpoint passing integrity;
                         with no ``--ckpt-dir``, a supervisor restart warns
                         LOUDLY that all progress is lost and re-runs from
                         step 0.
``--device D``           ``cuda`` (default) or ``cpu``
"""
from __future__ import annotations

import argparse
import warnings
from typing import Optional

import torch

from repro_torch import ft
from repro_torch._device import resolve_device
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import api
from repro_torch.models.common import ShardCtx, quantize_params
from repro_torch.train import faults as train_faults
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt
from repro_torch.train import step as step_mod

__all__ = ["build_state", "main"]


def build_state(cfg, gen: torch.Generator, quant: str):
    """Seeded weights on ``gen``'s device; ``pasm`` / ``qat`` quantize them
    (``impl="kernel"`` / ``"dequant"``).  Returns ``(cfg, params)``."""
    params = api.get_model(cfg).init_params(cfg, gen)
    if quant in ("pasm", "qat"):
        cfg = cfg.with_quant(enabled=True, impl="kernel" if quant == "pasm" else "dequant")
        params = quantize_params(params, cfg)
    return cfg, params


def _n_hosts() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--quant", default="dense", choices=["dense", "pasm", "qat"])
    ap.add_argument("--compress-grads", type=int, default=0, help="bins; 0=off")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3, help="checkpoint rotation depth")
    ap.add_argument("--resume", default="no", choices=["no", "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--guard-max-skip", type=int, default=3,
                    help="consecutive non-finite steps before escalating")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--faults-seed", type=int, default=None,
                    help="chaos drill: sample a TrainFaultPlan from this seed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 5))
    dcfg = DataConfig(seed=args.seed, vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch)
    mgr = ckpt.CheckpointManager(args.ckpt_dir, keep=args.keep) if args.ckpt_dir else None
    detector = ft.StragglerDetector(n_hosts=_n_hosts())
    plan = (train_faults.TrainFaultPlan.sample(args.faults_seed, n_steps=args.steps)
            if args.faults_seed is not None else None)
    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=args.max_restarts))
    losses: dict = {}
    step_times: dict = {}

    def loop(resume_step: Optional[int]) -> int:
        if sup.restarts and mgr is None:
            warnings.warn(
                "supervisor restart with no --ckpt-dir: ALL training progress "
                "is lost and the run re-executes from step 0 — pass --ckpt-dir "
                "to make restarts resume instead",
                RuntimeWarning,
                stacklevel=2,
            )
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        cfg_t, params = build_state(cfg, gen, args.quant)
        opt_state = opt.init_opt_state(params)
        start = 0
        if mgr and args.resume == "auto" and ckpt.latest_step(mgr.dir) is not None:
            # restore the resume hint when the supervisor threaded one
            # through, else the newest checkpoint passing integrity
            if resume_step is not None:
                (params, opt_state), manifest = ckpt.restore(
                    mgr.dir, (params, opt_state), step=resume_step)
            else:
                (params, opt_state), manifest = mgr.restore_latest((params, opt_state))
            start = manifest["step"]
            print(f"[train] resumed from step {start}")

        train_step = step_mod.make_train_step(
            cfg_t, ocfg, ShardCtx(), microbatches=args.microbatches,
            compress_grads_bins=args.compress_grads)
        res = loop_mod.run_loop(
            train_step,
            (params, opt_state),
            lambda s: synthetic_batch(dcfg, s, device=dev),
            steps=args.steps,
            start_step=start,
            mgr=mgr,
            ckpt_every=args.ckpt_every,
            ckpt_extra={"arch": args.arch},
            faults=plan,
            detector=detector,
            max_consecutive_nonfinite=args.guard_max_skip,
            log_every=args.log_every,
            losses=losses,
            step_times=step_times,
        )
        if res.n_skipped:
            print(f"[train] guard skipped {res.n_skipped} non-finite steps")
        if res.n_ckpt_failures:
            print(f"[train] {res.n_ckpt_failures} checkpoint saves failed (training continued)")
        if detector.stragglers():
            print(f"[train] stragglers detected: {detector.stragglers()}")
        return res.last_step

    with step_mod.deterministic():
        last = sup.run(loop)
    if plan is not None:
        print(f"[train] chaos drill: {len(plan.fired)} injections fired: "
              f"{[f[0] for f in plan.fired]}")
    print(f"[train] done at step {last} (restarts: {sup.restarts}, device {dev})")
    return last


if __name__ == "__main__":
    main()
