"""Serve a weight-shared model under continuous batching on the PyTorch port.

Trains nothing: initializes stablelm-3b's smoke config, applies the paper's
k-means weight sharing with a 256-entry dictionary, and serves mixed
traffic — 6 LM requests over 3 slots of the continuous-batching engine
(per-slot KV positions: a free slot prefills the moment a request arrives,
the other slots keep decoding) and 4 CNN image classifications staggered
in through the shape-bucketed batcher — once on the dense weights and once
on the weight-shared ones.  It prints each run's rollup (latency p50, tok/s,
img/s, slot occupancy) and, last, on how many requests the two greedy
outputs agree token for token (§5.3: "the results ... are identical").

On the card (the default) the weight-shared LM runs the fused-dequant kernel
(K1) and the CNN the PASM conv kernels; with ``--device cpu`` the kernel
wrappers run their plain PyTorch versions.  It exits non-zero when a
request is left unserved or an output token lies outside the vocabulary.

    PYTHONPATH=src python examples/torch/serve_pasm.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs import get_cnn_config, get_config  # noqa: E402
from repro_torch.models import api, cnn  # noqa: E402
from repro_torch.models.common import quantize_params, weight_bytes  # noqa: E402
from repro_torch.serve.batcher import CnnBatcher, MixedBatcher  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.serve.metrics import Metrics  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("stablelm-3b", smoke=True)
    model = api.get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))

    # the paper's pipeline: the weights into a 256-entry dictionary (large B is
    # near-lossless; B = 16 trades accuracy for 4x compression)
    qcfg = cfg.with_quant(enabled=True, bins=256, impl="kernel", min_weight_elems=1024)
    qparams = quantize_params(params, qcfg)
    wb = weight_bytes(qparams)
    print(f"[serve] weight bytes: {wb['dense']} dense → {wb['stored']} stored "
          f"({wb['ratio']:.2f}x)")

    ccfg = get_cnn_config("alexnet", smoke=True)
    cgen = torch.Generator(device=dev).manual_seed(1)
    cparams = cnn.quantize(cnn.init_params(ccfg, cgen, device=dev), ccfg)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 10))) for _ in range(6)]
    C, H, W = ccfg.in_chw
    images = [rng.standard_normal((C, int(rng.integers(8, H + 1)), int(rng.integers(8, W + 1))))
              .astype(np.float32) for _ in range(4)]

    results = {}
    for tag, c, p in (("dense", cfg, params), ("pasm", qcfg, qparams)):
        metrics = Metrics()
        eng = Engine(c, p, batch_slots=3, max_seq=64, metrics=metrics)
        cnn_b = CnnBatcher(ccfg, cparams, max_batch=3, metrics=metrics, device=dev)
        reqs = [eng.submit(pr, max_new=8) for pr in prompts]
        # stagger the images in: the engine keeps decoding while they classify
        mix = MixedBatcher(eng, cnn_b)
        imgs = []
        for im in images:
            imgs.append(cnn_b.submit(im))
            mix.tick()
        ticks = mix.run_until_drained()
        roll = metrics.rollup()
        print(f"[serve] {tag}: {roll['lm_n']} LM + {roll['cnn_n']} CNN requests in {ticks} "
              f"ticks, p50 latency {roll['lm_p50_latency_s']:.3f} s, {roll['tok_s']:.1f} "
              f"tok/s, {roll['img_s']:.1f} img/s, occupancy {roll['mean_occupancy']:.2f}")
        if not (all(r.done for r in reqs) and all(r.done for r in imgs)):
            raise AssertionError(f"{tag}: a request was left unserved")
        if not all(0 <= t < cfg.vocab for r in reqs for t in r.out):
            raise AssertionError(f"{tag}: an output token outside the vocabulary")
        results[tag] = [tuple(r.out) for r in reqs]

    agree = sum(a == b for a, b in zip(results["dense"], results["pasm"]))
    print(f"[serve] greedy outputs identical on {agree}/{len(prompts)} requests on {dev} "
          f"(256-bin dictionary ≈ lossless per step; greedy decode compounds any "
          f"single-token divergence)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
