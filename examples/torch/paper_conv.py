"""The paper's own experiment on the PyTorch port: the §4 conv accelerator.

Builds the configuration the paper evaluates (5×5 image, 15 channels, 3×3
kernels, M = 2, B ∈ {4, 8, 16}) on ``ConvParams``/``conv2d`` and reports
(a) the numerical equivalence of the non-weight-shared, weight-shared and
weight-shared-with-PASM variants, on the reference engines and on the four
kernel engines — ``kernel`` (K1 over an im2col patch matrix),
``kernel_implicit`` (K2), ``pas_kernel`` (K3) and ``pas_kernel_implicit``
(K4) — and (b) the calibrated hardware model's area, power and latency
beside the paper's quoted numbers (``PAPER_CLAIMS``).  Then it scales the
accelerator up: torchvision-exact SAME geometry on NHWC, and the
AlexNet-style CNN with per-layer dictionaries.

Every check raises on a miss, so the script exits non-zero.  On the card
(the default) each kernel engine launches its hand-written CUDA kernel,
counted; with ``--device cpu`` the wrappers run their plain versions.

    PYTHONPATH=src python examples/torch/paper_conv.py [--device cpu] [--smoke]
"""
import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.configs import get_cnn_config  # noqa: E402
from repro_torch.configs.alexnet_conv import PAPER_BINS, PAPER_SPEC  # noqa: E402
from repro_torch.core import conv as cv  # noqa: E402
from repro_torch.core import hwmodel as hw  # noqa: E402
from repro_torch.kernels import pasm_matmul as pm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

TOL = 1e-4  # |Δ| <= TOL + TOL·|ref|: the same f32 products in another order
# the kernel engine each conv2d engine launches
KERNEL_OF = {"kernel": "pasm_matmul", "kernel_implicit": "pasm_conv",
             "pas_kernel": "pas_matmul", "pas_kernel_implicit": "pas_conv"}


def close(got, want, what: str) -> float:
    d = (got - want).abs()
    if not bool((d <= TOL + TOL * want.abs()).all()):
        raise AssertionError(f"{what}: max|Δ| {float(d.max()):.2e} over the tolerance")
    return float(d.max())


def paper_variants(dev, gen) -> None:
    img = torch.randn((PAPER_SPEC.C, PAPER_SPEC.IH, PAPER_SPEC.IW), generator=gen, device=dev)
    kern = torch.randn((PAPER_SPEC.M, PAPER_SPEC.C, PAPER_SPEC.KY, PAPER_SPEC.KX),
                       generator=gen, device=dev)
    bias = torch.tensor([0.1, -0.1], device=dev)
    conv = PAPER_SPEC.conv(relu=True, bias=True)
    print(f"paper accelerator: image {PAPER_SPEC.IH}x{PAPER_SPEC.IW}x{PAPER_SPEC.C}, "
          f"kernel {PAPER_SPEC.KY}x{PAPER_SPEC.KX}, M={PAPER_SPEC.M}, "
          f"stride={PAPER_SPEC.stride}\n")
    for bins in PAPER_BINS:
        dense = cv.ConvParams.dense(kern, bias=bias)
        shared = cv.ConvParams.quantize(kern, bins, bias=bias)
        y_nws = cv.conv2d(img, dense, conv, engine="einsum")
        y_ws = cv.conv2d(img, shared, conv, engine="einsum")
        y_pasm = cv.conv2d(img, shared, conv, engine="pas_einsum")
        equiv = close(y_pasm, y_ws, f"B={bins} PASM vs weight-shared")
        qerr = float((y_nws - y_ws).abs().mean())
        asic, fpga, lat = hw.accel_ratio_asic(bins), hw.accel_ratio_fpga(bins), \
            hw.conv_latency_ratio(bins)
        print(f"B={bins:3d}: PASM≡weight-shared max|Δ|={equiv:.1e} "
              f"(quant err vs dense {qerr:.3f})")
        print(f"        ASIC: gates x{asic['gates']:.3f}  power x{asic['power']:.3f}  "
              f"latency x{lat:.4f}")
        print(f"        FPGA: DSPs x{fpga['dsp']:.2f} (405→3)  BRAM x{fpga['bram']:.2f}  "
              f"power x{fpga['power']:.3f}\n")
    claims = hw.PAPER_CLAIMS
    print("hardware model beside the paper (PASM / weight-shared, fractions remaining):")
    for b in (4, 8):
        asic = hw.accel_ratio_asic(b)
        print(f"  ASIC B={b}: gates {asic['gates']:.3f} (paper {claims[f'asic.gates_ratio.b{b}']:.3f})"
              f", power {asic['power']:.3f} (paper {claims[f'asic.power_ratio.b{b}']:.3f})")
    for b in PAPER_BINS:
        print(f"  FPGA B={b}: power {hw.accel_ratio_fpga(b)['power']:.3f} "
              f"(paper {claims[f'fpga.power_ratio.b{b}']:.3f})")
    print("paper headline (B=4, 32-bit): -47.8% gates, -53.2% power, +8.5% latency")
    print("model            (B=4, 32-bit): "
          f"-{(1 - hw.accel_ratio_asic(4)['gates']) * 100:.1f}% gates, "
          f"-{(1 - hw.accel_ratio_asic(4)['power']) * 100:.1f}% power, "
          f"+{(hw.conv_latency_ratio(4) - 1) * 100:.1f}% latency")
    batched_engines(kern, bias, dev, gen)


def batched_engines(kern, bias, dev, gen) -> None:
    """The same accelerator, batched, on the four kernel engines: one launch
    a layer, bias and ReLU fused, each held to the einsum engine."""
    print("\n— batched kernel engines (K1–K4, fused epilogue) —")
    imgs = torch.randn((4, PAPER_SPEC.C, PAPER_SPEC.IH, PAPER_SPEC.IW), generator=gen,
                       device=dev)
    conv = PAPER_SPEC.conv(relu=True, bias=True)
    for bins in PAPER_BINS:
        shared = cv.ConvParams.quantize(kern, bins, bias=bias)
        y_ref = cv.conv2d(imgs, shared, conv, engine="einsum")
        row = []
        for engine, key in KERNEL_OF.items():
            before = pm.launches[key]
            y = cv.conv2d(imgs, shared, conv, engine=engine)
            n = pm.launches[key] - before
            if dev.type == "cuda" and n != 1:
                raise AssertionError(f"{engine}: {n} launches of {key}, not 1")
            row.append(f"{engine} {close(y, y_ref, f'B={bins} {engine}'):.1e}")
        print(f"B={bins:3d} batch {imgs.shape[0]}: out {tuple(y_ref.shape)}, max|Δ| vs "
              f"einsum: " + ", ".join(row))


def same_nhwc_geometry(dev, gen, smoke: bool) -> None:
    """torchvision AlexNet layer 1 (k=11, s=4) under SAME + NHWC."""
    print("\n— SAME padding + NHWC (torchvision-exact geometry) —")
    hw_ = 64 if smoke else 224
    conv = cv.Conv2D(k=11, c_in=3, c_out=96, stride=4, padding="same",
                     layout="NHWC", relu=True)
    x = torch.randn((2, hw_, hw_, 3), generator=gen, device=dev)
    kern = torch.randn((96, 3, 11, 11), generator=gen, device=dev) * 0.05
    shared = cv.ConvParams.quantize(kern, 16, bias=torch.zeros(96, device=dev))
    packed = shared.pack(layout="NHWC")  # §3 K-pad: K=363 → 364, then int4
    y = cv.conv2d(x, shared, conv)
    y_packed = cv.conv2d(x, packed, conv)
    kern_q = shared.codebook[shared.idx.long()]  # dictionary deref
    oh = -(-hw_ // 4)
    pad = max((oh - 1) * 4 + 11 - hw_, 0)
    ref = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (pad // 2, pad - pad // 2) * 2), kern_q,
                   stride=4)
    ref = torch.relu(ref).permute(0, 2, 3, 1)
    print(f"conv1 out {tuple(y.shape)}; max|Δ| vs F.conv2d {close(y, ref, 'SAME NHWC'):.1e}; "
          f"int4-packed max|Δ| {close(y_packed, y, 'packed'):.1e} "
          f"({packed.idx.numel()} idx bytes vs {shared.idx.numel()} unpacked)")


def cnn_stack(dev, gen, smoke: bool) -> None:
    """Per-layer PASM dictionaries through the AlexNet-style stack."""
    print("\n— AlexNet-style CNN (per-layer PASM codebooks) —")
    cfg = get_cnn_config("alexnet", smoke=smoke)
    params = cnn.init_params(cfg, gen, device=dev)
    qparams = cnn.quantize(params, cfg)
    imgs = torch.randn((2, *cfg.in_chw), generator=gen, device=dev)
    logits = cnn.forward(qparams, imgs, cfg)
    dense = cnn.forward_dense(params, imgs, cfg)
    corr = float(torch.corrcoef(torch.stack([logits.flatten(), dense.flatten()]))[0, 1])
    print(f"{cfg.name}: {len(cfg.layers)} conv layers (B={cfg.bins} bins each) "
          f"→ logits {tuple(logits.shape)}; corr(dense)={corr:.3f}")
    ein = cnn.forward(qparams, imgs, dataclasses.replace(cfg, impl="einsum"))
    d = float((logits - ein).abs().max())
    print(f"{cfg.impl} vs einsum engines: max|Δ|={d:.1e}")
    if not (torch.isfinite(logits).all() and d <= 1e-3 * (1 + float(ein.abs().max()))):
        raise AssertionError("the CNN's kernel logits are off the einsum engine's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke CNN and a 64x64 SAME image")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":  # f32 convolutions in full f32 for the F.conv2d oracle
        torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        paper_variants(dev, gen)
        same_nhwc_geometry(dev, gen, args.smoke)
        cnn_stack(dev, gen, args.smoke)
    print(f"\npaper_conv OK on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
