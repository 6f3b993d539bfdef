"""Where K3/K4's time goes: the kernels as built, and two copies with a part
taken out, timed at the five AlexNet conv stages at batch 32 on the card.

* ``walk-only``: the stage loads after the first are skipped (every stage
  walks the first one's data): the ballot walk, the barriers and the epilogue;
* ``loads-only``: the walk is replaced by the ballots alone: the loads of x
  (or the patch gather) and of the index bytes, the barriers and the epilogue.

The two copies give wrong results; only their times mean anything.  Run on a
machine with the CUDA toolkit, from the repository root::

    PYTHONPATH=src python -m repro_torch.kernels.pas_ablation

Nothing runs at import.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import pas_histogram as ph

WALK = "    pas_walk(S[b], __ballot_sync(0xffffffffu, mine == (unsigned)b), base31, ldb);"
BALLOTS = "    S[b][0] += __uint_as_float(__ballot_sync(0xffffffffu, mine == (unsigned)b));"
FETCH = "        pas_fetch(ld, t, s + 1);\n"
PUT = "        pas_put(ld, ring + (slot ^ 1) * slot_floats, t);\n"
VARIANTS = {"as built": [], "walk-only": [(FETCH, ""), (PUT, "")],
            "loads-only": [(WALK, BALLOTS)]}
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _build_variants() -> dict:
    out = _build.BUILD_DIR / "pas_ablation"
    common = (_build.CSRC / "pas_common.cuh").read_text()
    procs = {}
    for v, subs in VARIANTS.items():
        d = out / v.replace(" ", "_")
        d.mkdir(parents=True, exist_ok=True)
        text = common
        for a, b in subs:
            if a not in text:
                raise RuntimeError(f"{v}: pas_common.cuh no longer holds {a!r}")
            text = text.replace(a, b)
        for f in _build.CSRC.iterdir():
            (d / f.name).write_text(text if f.name == "pas_common.cuh" else f.read_text())
        for k in ("pas_matmul", "pas_conv"):
            procs[(v, k)] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / f"{k}.so"),
                 str(d / f"{k}.cu")], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (v, k), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{v} {k}.cu failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(str(out / v.replace(" ", "_") / f"{k}.so")), k + "_launch")
        fn.argtypes = ([_P] * 6 + [_L] + [_I] * 7 + [_P]) if k == "pas_matmul" \
            else ([_P] * 6 + [_I] * 20 + [_P])
        fn.restype = _I
        libs[(v, k)] = fn
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
        print("pas_ablation: no CUDA card", file=sys.stderr)
        return 2
    from repro_torch.configs import alexnet_conv
    from repro_torch.core import conv as cv
    from repro_torch.core import pasm as _pasm
    from repro_torch.models import cnn

    torch.set_grad_enabled(False)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    libs = _build_variants()
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
        idx = _pasm.logical_idx(t).contiguous()
        cb, bias = t.codebook.contiguous(), p.bias.float().contiguous()
        x, _ = cv._im2col(img, conv)
        if pool > 1:
            x = cv._pool_order_patches(x, 32, g.oh, g.ow, pool)
        x = torch.nn.functional.pad(x, (0, p.pad_k)).contiguous()
        M, K = x.shape
        N, B = idx.shape[1], cb.shape[1]
        plan = ph.pas_plan(M, K, N, B, pool)
        out = torch.empty((M // (pool * pool), N), device="cuda")
        part = torch.empty(max(plan.scratch, 1), device="cuda")
        (plh, _), (plw, _) = g.pad
        line = []
        for (v, k), fn in libs.items():
            if k == "pas_matmul":
                args = (x.data_ptr(), idx.data_ptr(), cb.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), part.data_ptr(), M, K, N, B, 1, pool,
                        plan.tile, plan.splits)
            else:
                args = (img.data_ptr(), idx.data_ptr(), cb.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), part.data_ptr(), 32, C, H, W, 0, g.ky, g.kx,
                        g.stride, plh, plw, g.ow, pool, g.P_out, g.conv_k, K, N, B, 1,
                        plan.tile, plan.splits)
            ms = _time_ms(lambda: fn(*args, stream()))
            tot[(v, k)] += ms
            line.append(f"{'K3' if k == 'pas_matmul' else 'K4'} {v} {ms:.4f}")
        print(f"{C}x{H}x{W} k{conv.k} (M {M}, K {K}, N {N}, splits {plan.splits}) ms: "
              + ", ".join(line) + f" [{card}]", flush=True)
        H, W = cv.conv_out_hw(H, W, conv)
        H, W, C = H // pool, W // pool, conv.c_out
    print("summed ms: " + ", ".join(
        f"{'K3' if k == 'pas_matmul' else 'K4'} {v} {ms:.4f}" for (v, k), ms in tot.items())
        + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
