"""Serving launcher: continuous-batching engine + mixed CNN traffic.

Port of ``repro.launch.serve``.  Brings up the PASM-quantized
:class:`~repro_torch.serve.engine.Engine`, optionally a
:class:`~repro_torch.serve.batcher.CnnBatcher` for concurrent image traffic,
runs the load through the :class:`~repro_torch.serve.batcher.MixedBatcher`
loop, and prints the metrics rollup (p50/p99 latency and TTFT per class,
tok/s, img/s, slot occupancy) plus the failure counters whenever anything
failed.  It runs on the card unless ``--device cpu`` is given; as in the
JAX launcher, quantized weights serve on ``impl="dequant"``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-32b --smoke \\
        --device cpu --requests 8 --images 4
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_cnn_config, get_config
from repro_torch.models import api, cnn
from repro_torch.models.common import quantize_params, weight_bytes
from repro_torch.serve.batcher import CnnBatcher, MixedBatcher
from repro_torch.serve.engine import Engine
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.metrics import FAILURE_COUNTERS, Metrics


def _fmt(v, unit=""):
    if isinstance(v, float):
        return "n/a" if math.isnan(v) else f"{v:.4g}{unit}"
    return f"{v}{unit}"


def print_rollup(roll: dict, slots: int) -> None:
    print(f"[serve] requests: {roll['n_done']}/{roll['n_requests']} done, "
          f"{roll['n_stuck']} stuck; mean occupancy "
          f"{_fmt(roll['mean_occupancy'])} over {slots} slots")
    for kind, rate in (("lm", "tok_s"), ("cnn", "img_s")):
        if not roll[f"{kind}_n"]:
            continue
        print(f"[serve]   {kind}: n={roll[f'{kind}_n']}  "
              f"latency p50={_fmt(roll[f'{kind}_p50_latency_s'], 's')} "
              f"p99={_fmt(roll[f'{kind}_p99_latency_s'], 's')}  "
              f"ttft p50={_fmt(roll[f'{kind}_p50_ttft_s'], 's')} "
              f"p99={_fmt(roll[f'{kind}_p99_ttft_s'], 's')}  "
              f"{rate}={_fmt(roll[rate])}")
    if roll["slo_met"] or roll["slo_missed"]:
        print(f"[serve]   SLO: {roll['slo_met']} met, {roll['slo_missed']} missed")
    tripped = {k: roll[k] for k in FAILURE_COUNTERS if roll.get(k)}
    if tripped or roll.get("n_failed"):
        counts = " ".join(f"{k[2:]}={v}" for k, v in tripped.items())
        print(f"[serve]   failures: n_failed={roll.get('n_failed', 0)}  {counts}")
        for kind in ("deadline", "numeric", "error", "rejected"):
            n = roll.get(f"failed_{kind}_n", 0)
            if n:
                print(f"[serve]     {kind}: n={n}  latency "
                      f"p50={_fmt(roll[f'failed_{kind}_p50_latency_s'], 's')} "
                      f"p99={_fmt(roll[f'failed_{kind}_p99_latency_s'], 's')}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="pasm", choices=["dense", "pasm"])
    ap.add_argument("--bins", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8, help="LM requests")
    ap.add_argument("--images", type=int, default=0, help="CNN classify requests")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request latency budget (SLO accounting)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded queue depth (backpressure)")
    ap.add_argument("--policy", default="reject",
                    help="bounded-queue admission policy: reject | "
                         "shed_oldest | shed_expired")
    ap.add_argument("--max-retries", type=int, default=1)
    ap.add_argument("--faults-seed", type=int, default=None,
                    help="chaos drill: inject a FaultPlan sampled from this seed")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the plain path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = api.get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    if args.quant == "pasm":
        cfg = cfg.with_quant(enabled=True, bins=args.bins, impl="dequant")
        params = quantize_params(params, cfg)
        wb = weight_bytes(params)
        print(
            f"[serve] PASM weights: {wb['dense']/1e6:.1f} MB dense → "
            f"{wb['stored']/1e6:.1f} MB stored ({wb['ratio']:.1f}× compression)"
        )

    metrics = Metrics()
    slo_s = args.slo_ms / 1e3 if args.slo_ms else None
    faults = None
    if args.faults_seed is not None:
        faults = FaultPlan.sample(
            args.faults_seed, n_ticks=max(8, args.max_new + 2),
            n_slots=args.slots, n_requests=args.requests,
        )
        print(f"[serve] chaos drill: {len(faults.faults)} faults sampled "
              f"from seed {args.faults_seed}")
    eng = Engine(cfg, params, batch_slots=args.slots, max_seq=args.max_seq,
                 metrics=metrics, faults=faults, max_retries=args.max_retries,
                 max_queue=args.max_queue, policy=args.policy)
    rng = np.random.default_rng(args.seed)
    reqs = [
        eng.submit(rng.integers(0, cfg.vocab, size=int(rng.integers(4, 12))),
                   args.max_new, slo_s=slo_s)
        for _ in range(args.requests)
    ]

    cnn_b = None
    if args.images:
        ccfg = get_cnn_config("alexnet", smoke=args.smoke)
        cgen = torch.Generator(device=dev).manual_seed(args.seed)
        cparams = cnn.quantize(cnn.init_params(ccfg, cgen, device=dev), ccfg)
        cnn_b = CnnBatcher(ccfg, cparams, max_batch=args.slots, metrics=metrics,
                           device=dev)
        C, H, W = ccfg.in_chw
        for _ in range(args.images):
            h = int(rng.integers(8, H + 1))
            w = int(rng.integers(8, W + 1))
            cnn_b.submit(rng.standard_normal((C, h, w)).astype(np.float32), slo_s=slo_s)

    ticks = MixedBatcher(eng, cnn_b).run_until_drained()
    print(f"[serve] drained in {ticks} ticks on {dev}")
    print_rollup(metrics.rollup(), args.slots)
    for r in reqs[:3]:
        print(f"  req {r.uid}: prompt[{len(r.prompt)}] → {r.out[:8]}...")
    return 0


if __name__ == "__main__":
    main()
