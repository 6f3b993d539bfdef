"""Where the SIMT kernels' time goes: K1/K2 and K3/K4 as built, and copies
with a part taken out, timed at the five AlexNet conv stages at batch 32 on
the card.

K1/K2 (``csrc/pasm_common.cuh``, the f32 SIMT GEMM body):

* ``product-only``: the stage copies and the dequant after the prologue are
  skipped (every stage multiplies the first stages' tiles): the product,
  the barriers and the epilogue;
* ``FFMA-only``: product-only with the product's shared-memory reads
  replaced by registers: the FMA chains, the barriers and the epilogue;
* ``staging-only``: the product is replaced by one add a stage: the
  ``cp.async`` copies (or K2's gather), the dequant, the barriers and the
  epilogue.

K3/K4 (``csrc/pas_common.cuh``, the PAS walk):

* ``walk-only``: the stage loads after the first are skipped (every stage
  walks the first one's data): the ballot walk, the barriers and the epilogue;
* ``loads-only``: the walk is replaced by the ballots alone: the loads of x
  (or the patch gather) and of the index bytes, the barriers and the epilogue.

The copies give wrong results; only their times mean anything.  Run on a
machine with the CUDA toolkit, from the repository root (``simt`` or ``pas``
times one family)::

    PYTHONPATH=src python -m repro_torch.kernels.ablation [simt|pas]

Nothing runs at import.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import pas_histogram as ph
from repro_torch.kernels import pasm_matmul as pm

WALK = "    pas_walk(S[b], __ballot_sync(0xffffffffu, mine == (unsigned)b), base31, ldb);"
BALLOTS = "    S[b][0] += __uint_as_float(__ballot_sync(0xffffffffu, mine == (unsigned)b));"
FETCH = "        pas_fetch(ld, t, s + 1);\n"
PUT = "        pas_put(ld, ring + (slot ^ 1) * slot_floats, t);\n"
STAGE = ("    ld.refill(t, s + SIMT_DEPTH);\n    issue(s + SIMT_DEPTH);\n"
         "    if (s + 1 < t.nst)\n")
PRODUCT = ("    simt_product<S>(xs + (s % SIMT_XSLOTS) * S::X_SLOT,\n"
           "                    ws + (s & 1) * S::W_SLOT, acc, ty, tx);")
ONE_ADD = ("    acc[0][0] += xs[(s % SIMT_XSLOTS) * S::X_SLOT + threadIdx.x] +\n"
           "                 ws[(s & 1) * S::W_SLOT + threadIdx.x];")
REGISTERS = [  # the product's operands from a register, not shared memory
    ("  for (int kq = 0; kq < SIMT_BK / 4; ++kq) {\n    float4 a[S::TM];",
     "  const float z = xs[threadIdx.x % 4];\n"
     "  for (int kq = 0; kq < SIMT_BK / 4; ++kq) {\n    float4 a[S::TM];"),
    ("      a[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * SIMT_XLD +\n"
     "                                              4 * kq);",
     "      a[i] = make_float4(z + i, z - i, z * i, z + kq);"),
    ("const float4 b0 = *reinterpret_cast<const float4*>(wr + 4 * tx);",
     "const float4 b0 = make_float4(z + kk, z - kk, z * kk, z + 2 * kk);"),
    ("const float4 b1 = *reinterpret_cast<const float4*>(wr + 64 + 4 * tx);",
     "const float4 b1 = make_float4(z + 3 * kk, z - 3 * kk, z * kk + 1, z + 5 * kk);"),
    ("const float2 b1 = *reinterpret_cast<const float2*>(wr + 64 + 2 * tx);",
     "const float2 b1 = make_float2(z + 3 * kk, z - 3 * kk);"),
]
PRODUCT_ONLY = [(STAGE, "    cp_async_commit();\n    if (false)\n")]
# family -> (header, (explicit kernel, implicit kernel), variant -> edits)
FAMILIES = {
    "simt": ("pasm_common.cuh", ("pasm_matmul", "pasm_conv"), {
        "as built": [], "product-only": PRODUCT_ONLY,
        "FFMA-only": PRODUCT_ONLY + REGISTERS,
        "staging-only": [(PRODUCT, ONE_ADD)]}),
    "pas": ("pas_common.cuh", ("pas_matmul", "pas_conv"), {
        "as built": [], "walk-only": [(FETCH, ""), (PUT, "")],
        "loads-only": [(WALK, BALLOTS)]}),
}
NAMES = {"pasm_matmul": "K1", "pasm_conv": "K2", "pas_matmul": "K3", "pas_conv": "K4"}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
ARGTYPES = {"pasm_matmul": [_P] * 6 + [_L] + [_I] * 10 + [_P],
            "pasm_conv": [_P] * 6 + [_L] + [_I] * 22 + [_P],
            "pas_matmul": [_P] * 6 + [_L] + [_I] * 7 + [_P],
            "pas_conv": [_P] * 6 + [_I] * 20 + [_P]}


def _build_variants(families) -> dict:
    """{(kernel, variant): the C entry point of that variant's build}."""
    out = _build.BUILD_DIR / "ablation"
    procs = {}
    for fam in families:
        header, kernels, variants = FAMILIES[fam]
        common = (_build.CSRC / header).read_text()
        for v, subs in variants.items():
            d = out / fam / v.replace(" ", "_")
            d.mkdir(parents=True, exist_ok=True)
            text = common
            for a, b in subs:
                if a not in text:
                    raise RuntimeError(f"{v}: {header} no longer holds {a!r}")
                text = text.replace(a, b)
            for f in _build.CSRC.iterdir():
                (d / f.name).write_text(text if f.name == header else f.read_text())
            for k in kernels:
                procs[(k, v)] = (d, subprocess.Popen(
                    [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{k}.so"),
                     str(d / f"{k}.cu")], stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (k, v), (d, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{v} {k}.cu failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(str(d / f"{k}.so")), k + "_launch")
        fn.argtypes = ARGTYPES[k]
        fn.restype = _I
        libs[(k, v)] = fn
    return libs


def _time_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("ablation: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import alexnet_conv
    from repro_torch.core import conv as cv
    from repro_torch.core import pasm as _pasm
    from repro_torch.models import cnn

    families = [f for f in FAMILIES if f in sys.argv[1:]] or list(FAMILIES)
    torch.set_grad_enabled(False)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    libs = _build_variants(families)
    cfg = alexnet_conv.config()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qparams = cnn.quantize(cnn.init_params(cfg, gen, device="cuda"), cfg)
    stream = lambda: torch.cuda.current_stream().cuda_stream
    C, H, W = cfg.in_chw
    tot = dict.fromkeys(libs, 0.0)
    for (conv, pool), p in zip(cnn.stages(cfg), qparams["conv"]):
        img = torch.randn((32, C, H, W), generator=gen, device="cuda")
        g = cv.conv_geom(conv, H, W, pool=pool)
        t = p.gemm_tensor(conv.layout)
        li = _pasm.logical_idx(t).contiguous()
        idx, cb, bias = t.idx.contiguous(), t.codebook.contiguous(), p.bias.float().contiguous()
        x, _ = cv._im2col(img, conv)
        if pool > 1:
            x = cv._pool_order_patches(x, 32, g.oh, g.ow, pool)
        x = torch.nn.functional.pad(x, (0, p.pad_k)).contiguous()
        M, K = x.shape
        N, (G, B) = li.shape[1], cb.shape
        pas, simt = ph.pas_plan(M, K, N, B, pool), pm.simt_plan(M, K, N, pool)
        out = torch.empty((M // (pool * pool), N), device="cuda")
        part = torch.empty(max(pas.scratch, simt.scratch, 1), device="cuda")
        (plh, _), (plw, _) = g.pad
        geom = (C, H, W, 0, g.ky, g.kx, g.stride, plh, plw, g.ow, pool, g.P_out, g.conv_k, K, N)
        ptrs = lambda xin, i: (xin.data_ptr(), i.data_ptr(), cb.data_ptr(), bias.data_ptr(),
                               out.data_ptr(), part.data_ptr())
        args = {
            "pasm_matmul": ptrs(x, idx) + (M, K, N, G, B, int(t.packed), 1, pool,
                                           simt.tile, simt.cols, simt.splits),
            "pasm_conv": ptrs(img, idx) + (32,) + geom + (G, B, int(t.packed), 1,
                                                          simt.tile, simt.cols, simt.splits),
            "pas_matmul": ptrs(x, li) + (M, K, N, B, 1, pool, pas.tile, pas.splits),
            "pas_conv": ptrs(img, li) + (32,) + geom + (B, 1, pas.tile, pas.splits),
        }
        line = []
        for (k, v), fn in libs.items():
            ms = _time_ms(lambda: fn(*args[k], stream()))
            tot[(k, v)] += ms
            line.append(f"{NAMES[k]} {v} {ms:.4f}")
        print(f"{C}x{H}x{W} k{conv.k} (M {M}, K {K}, N {N}; splits K1/K2 {simt.splits}, "
              f"K3/K4 {pas.splits}) ms: " + ", ".join(line) + f" [{card}]", flush=True)
        H, W = cv.conv_out_hw(H, W, conv)
        H, W, C = H // pool, W // pool, conv.c_out
    print("summed ms: " + ", ".join(
        f"{NAMES[k]} {v} {ms:.4f}" for (k, v), ms in tot.items()) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
