"""End-to-end driver on the PyTorch port: train a ~100M-param dense LM.

Exercises the training stack on one device: config system → model zoo →
data pipeline → AdamW → checkpointing → PASM post-training quantization of
the result, reporting the compression ratio and the held-out loss of the
weight-shared model on the fused-dequant kernel (K1).

~100M params: 12 layers, d_model 768, 12 heads, d_ff 3072, vocab 32k (a
GPT-2-small-class decoder built from the qwen3 family config); ``--smoke``
trains the qwen3 smoke config instead.  The run checks that the loss is
finite and falls, and that the quantized model's loss is finite; it exits
non-zero otherwise.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300] [--device cpu] [--smoke]
"""
import argparse
import dataclasses
import math
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.common import param_count, quantize_params, weight_bytes  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import step as step_mod  # noqa: E402


def lm_100m() -> ArchConfig:
    return dataclasses.replace(
        get_config("qwen3-32b", smoke=True),
        name="lm-100m",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=3072,
        vocab=32_000,
        remat=False,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=None, help="default 300 (smoke: 30)")
    ap.add_argument("--batch", type=int, default=None, help="default 8 (smoke: 4)")
    ap.add_argument("--seq", type=int, default=None, help="default 256 (smoke: 64)")
    ap.add_argument("--ckpt-dir", default=None, help="default: a temporary directory")
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true", help="the qwen3 smoke config")
    args = ap.parse_args(argv)
    steps = args.steps or (30 if args.smoke else 300)
    batch = args.batch or (4 if args.smoke else 8)
    seq = args.seq or (64 if args.smoke else 256)
    dev = resolve_device(args.device)

    cfg = get_config("qwen3-32b", smoke=True) if args.smoke else lm_100m()
    model = api.get_model(cfg)
    params = model.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    print(f"[example] {cfg.name}: {param_count(params) / 1e6:.1f}M params on {dev}")

    state = opt.init_opt_state(params)
    ocfg = opt.AdamWConfig(lr=6e-4, total_steps=steps, warmup_steps=min(20, steps // 2))
    dcfg = DataConfig(seed=0, vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    train_step = step_mod.make_train_step(cfg, ocfg)
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        mgr = ck.CheckpointManager(args.ckpt_dir or tmp, keep=2)
        t0 = time.perf_counter()
        for step in range(steps):
            params, state, m = train_step(params, state,
                                          synthetic_batch(dcfg, step, device=dev))
            losses.append(float(m["loss"]))
            if (step + 1) % 25 == 0 or step == 0:
                print(f"[example] step {step + 1:4d}  loss {losses[-1]:.4f}  "
                      f"lr {float(m['lr']):.2e}  "
                      f"{(time.perf_counter() - t0) / (step + 1) * 1e3:.0f} ms/step "
                      f"(host clock, first steps included)")
            if (step + 1) % 100 == 0 or step + 1 == steps:
                mgr.save(step + 1, (params, state))
        mgr.wait()
    window = max(1, steps // 10)
    first, last = sum(losses[:window]) / window, sum(losses[-window:]) / window
    if not (all(math.isfinite(v) for v in losses) and last < first):
        raise AssertionError(f"the loss did not fall: {first:.4f} → {last:.4f}")

    # the paper's pipeline: post-training weight sharing of the trained model,
    # served on the fused-dequant kernel
    qcfg = cfg.with_quant(enabled=True, bins=16, impl="kernel", min_weight_elems=1024)
    qparams = quantize_params(params, qcfg)
    wb = weight_bytes(qparams)
    print(f"[example] PASM 16-bin quantization: {wb['dense'] / 1e6:.1f} MB → "
          f"{wb['stored'] / 1e6:.1f} MB ({wb['ratio']:.2f}x)")
    held = synthetic_batch(dcfg, 10_000, device=dev)
    loss_q = float(step_mod.make_eval_step(qcfg)(qparams, held)["loss"])
    loss_d = float(step_mod.make_eval_step(cfg)(params, held)["loss"])
    print(f"[example] held-out loss dense {loss_d:.4f} vs PASM-16 {loss_q:.4f} "
          f"(Δ {loss_q - loss_d:+.4f})")
    if not (math.isfinite(loss_q) and math.isfinite(loss_d)):
        raise AssertionError("a held-out loss is not finite")
    print(f"[example] train_lm OK on {dev}: loss {first:.4f} → {last:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
