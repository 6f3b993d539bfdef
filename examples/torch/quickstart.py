"""Quickstart on the PyTorch port: the PASM identity end to end.

1. Reproduce the paper's Fig 4 / Fig 6 worked example.
2. Weight-share a weight matrix (k-means dictionary, Han et al. style).
3. Run the fused-dequant kernel (K1) against the weight-shared baseline.
4. Show the weight-byte reduction that motivates PASM at decode.
5. PasmParams: one container from conv to transformer — per-layer
   compression ratios and the unified ``linear()`` dispatch.

Every step checks its result and the script exits non-zero when one is off.
On the card (the default) K1 runs as the hand-written CUDA kernel; with
``--device cpu`` the kernel wrappers run their plain PyTorch versions.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--smoke]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch  # noqa: E402

from repro_torch._device import resolve_device  # noqa: E402
from repro_torch.core import pas, pasm  # noqa: E402
from repro_torch.core.params import PasmParams  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.pasm_matmul import K1_BF16_TOL, pasm_matmul_plain  # noqa: E402
from repro_torch.nn import layers as L  # noqa: E402

TOL = 1e-4  # f32 kernel vs plain: the same products summed in another order


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default: the card")
    ap.add_argument("--smoke", action="store_true", help="smaller matrices")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)

    # -- 1. the paper's worked example (Figures 4 and 6) --------------------
    x = torch.tensor([26.7, 3.4, 4.8, 17.7, 6.1], device=dev)
    bin_index = torch.tensor([0, 1, 2, 3, 0], dtype=torch.uint8, device=dev)
    codebook = torch.tensor([1.7, 0.4, 1.3, 2.0], device=dev)  # the shared weights
    ws = pas.weight_shared_dot(x, bin_index, codebook)  # Fig 4: deref + MAC
    bins = pas.pas_accumulate(x, bin_index, 4)  # Fig 6a: PAS phase (adds only)
    out = pas.pas_postpass(bins, codebook)  # Fig 6b: B multiplies
    print(f"weight-shared MAC : {float(ws):.2f}   (paper: 98.8)")
    print(f"PAS bins          : {[round(b, 2) for b in bins.tolist()]}     "
          "(paper: [32.8, 3.4, 4.8, 17.7])")
    print(f"PASM post-pass    : {float(out):.2f}   — identical result, 4 multiplies not 5")
    check(round(float(ws), 1) == 98.8 and abs(float(out) - float(ws)) < 1e-4,
          "the worked example does not reproduce the paper's 98.8")

    # -- 2. weight-share a layer ----------------------------------------------
    K, N = (256, 128) if args.smoke else (1024, 512)
    w = torch.randn((K, N), generator=gen, device=dev)
    t = pasm.quantize(w, bins=16)  # 16 shared values → 4-bit indices, packed
    err = float((w - pasm.dequantize(t)).abs().mean())
    print(f"\nquantized {K}x{N} f32 layer → {t.bins} bins, "
          f"{t.compression_ratio:.1f}x smaller than bf16 in memory")
    print(f"  reconstruction |err| = {err:.4f}")
    check(t.compression_ratio > 3.9 and err < 0.1, "16-bin k-means lost the layer")

    # -- 3. the fused kernel vs the oracle -----------------------------------
    xb = torch.randn((8, K), generator=gen, device=dev).to(torch.bfloat16)
    y_kernel = ops.pasm_matmul(xb, t)  # K1: dequantized in the tile, never in memory
    y_oracle = pasm_matmul_plain(xb, t.idx, t.codebook, packed=t.packed)  # its plain version
    scale = xb.float().abs() @ pasm.dequantize(t).abs()
    d = (y_kernel - y_oracle).abs()
    print(f"\nfused-kernel max err vs oracle: {float(d.max()):.2e}")
    check(bool((d <= K1_BF16_TOL * scale + 1e-6).all()), "K1 is off its oracle")

    # -- 4. why this matters at decode ----------------------------------------
    dense_bytes = w.numel() * 2
    print(f"\ndecode-step weight traffic: {dense_bytes} B (bf16) → {t.nbytes_weights} B "
          f"(PASM) = {dense_bytes / t.nbytes_weights:.1f}x fewer bytes in the "
          f"bandwidth-bound regime")

    # -- 5. PasmParams: one container, every layer ----------------------------
    D, F = (64, 256) if args.smoke else (256, 1024)
    layers = {
        "attn.wqkv": PasmParams.quantize(torch.randn((D, 3 * D), generator=gen, device=dev),
                                         bins=16).pack(),
        "ffn.w1": PasmParams.quantize(torch.randn((D, F), generator=gen, device=dev),
                                      bins=16, groups=4),
        "ffn.w2": PasmParams.dense(torch.randn((F, D), generator=gen, device=dev)),
    }
    print("\nPasmParams per-layer compression (vs bf16):")
    for name, p in layers.items():
        print(f"  {name:10s} kind={p.kind:6s} bins={p.bins} bits={p.bits} "
              f"groups={p.groups}  {p.compression_ratio:.2f}x")
    xt = torch.randn((4, D), generator=gen, device=dev)
    y_fused = L.linear(xt, layers["attn.wqkv"], "kernel")  # K1's f32 route
    y_ref = L.linear(xt, layers["attn.wqkv"], "dequant")  # dequantize → matmul oracle
    d = (y_fused - y_ref).abs()
    print(f"linear(kernel) vs dequant max err: {float(d.max()):.2e}")
    check(bool((d <= TOL + TOL * y_ref.abs()).all()), "linear(kernel) is off dequant")
    print(f"\nquickstart OK on {dev}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
