#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and hold each
hand-written kernel against its plain PyTorch version.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (every one unguarded: any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (``nvcc``);
3. K1 (fused-dequant GEMM), K2 (implicit-GEMM conv), K3 (two-phase PAS
   GEMM) and K4 (implicit-GEMM PAS conv) against their plain versions at the
   five full-width AlexNet conv stages, shared and packed dictionaries, plus
   a ``groups=2`` case (K1/K2), 4- and 256-bin dictionaries and indices past
   the dictionary (K3/K4) on conv3, an NHWC SAME conv1 case and the
   3×512×512 ``bigimg_conv1`` shape on K2/K4; K1 ≡ K2 and K3 ≡ K4 bitwise on
   each stage, and on integer-valued images and dictionaries K3 == K1
   bitwise (paper §5.3);
4. the full-width AlexNet (3×224×224, 1000 classes, 16 bins, seeded weights,
   k-means on the card) serving mixed-size requests through ``CnnBatcher``
   with ``impl="kernel"``, ``"kernel_implicit"`` and ``"pas_kernel"``, then
   one batch through the five stages on ``conv2d(engine=
   "pas_kernel_implicit")``; launch counts are read around each run and the
   logits are held against the ``einsum`` engine on the card;
5. CUDA-event timings at batch 32 per stage: kernel, plain version, a
   library yardstick (timed only: ``torch.matmul`` on the dequantized weight
   for K1/K3, ``F.conv2d`` with TF32 off for K2/K4) and the bound
   ``max(flops / 67 TFLOP/s, bytes / 3.35 TB/s)`` of the function (K3's is
   K1's, K4's is K2's);
6. one ``{"kernels": [...]}`` JSON line;
7. last line: ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, when CUDA is unavailable or when the
repository's ``src/`` is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL = 1e-4  # kernel vs plain: |Δ| <= TOL + TOL·|plain| (f32 summation order)
LOGIT_TOL = 1e-3  # served logits vs the einsum engine (five layers + head)
F32_TFLOPS = 67.0  # H100 SXM f32 (non-tensor-core) peak
HBM_TBPS = 3.35  # H100 SXM HBM3
TIME_BATCH = 32
KERNELS = ("pasm_matmul", "pasm_conv", "pas_matmul", "pas_conv")
# the kernel each served engine launches (five per batch, and no other)
SERVED_KERNEL = {"kernel": "pasm_matmul", "kernel_implicit": "pasm_conv",
                 "pas_kernel": "pas_matmul"}


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def max_err(got, want) -> float:
    """Max |Δ|; raises when an element is over ``TOL + TOL·|want|``."""
    import torch

    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    d = (got - want).abs()
    bad = d > TOL + TOL * want.abs()
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} elements over tolerance, "
                             f"max |Δ| {float(d.max()):.3e}")
    return float(d.max())


def time_ms(fn, budget_s: float = 0.25) -> float:
    """Mean device ms per call over a CUDA-event window, after warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-5)
    reps = int(min(50, max(3, budget_s / once)))
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@dataclasses.dataclass
class Case:
    """One conv stage on the kernels: inputs on the card plus operands."""

    name: str
    conv: object  # Conv2D
    pool: int
    params: object  # ConvParams (shared / packed)
    img: object  # (B, C, H, W) or (B, H, W, C) on the card

    def geom(self):
        from repro_torch.core import conv as cv

        nhwc = self.conv.layout == "NHWC"
        ih, iw = (self.img.shape[1], self.img.shape[2]) if nhwc \
            else (self.img.shape[2], self.img.shape[3])
        return cv.conv_geom(self.conv, ih, iw, pool=self.pool)

    def patches(self):
        """K1's operand: the window-major im2col patch matrix (+ pad_k)."""
        import torch.nn.functional as F

        from repro_torch.core import conv as cv

        g = self.geom()
        p, _ = cv._im2col(self.img, self.conv)
        if self.pool > 1:
            p = cv._pool_order_patches(p, self.img.shape[0], g.oh, g.ow, self.pool)
        if self.params.pad_k:
            p = F.pad(p, (0, self.params.pad_k))
        return p.contiguous()


def check_case(case: Case, errs: dict, *, k1: bool = True, pasm: bool = True,
               pas: bool = True) -> None:
    """K1 and K2 (``pasm``) and K3 and K4 (``pas``, one dictionary) against
    their plain versions, K1 ≡ K2 and K3 ≡ K4 bitwise; ``k1=False`` skips
    the explicit kernels."""
    import torch

    from repro_torch.core import pasm as _pasm
    from repro_torch.kernels import ops, pas_histogram as ph, pasm_matmul as pm

    t = case.params.gemm_tensor(case.conv.layout)
    bias = case.params.bias
    g = case.geom()
    x = case.patches() if k1 else None
    line = f"  {case.name:<30}"
    if pas and case.params.groups == 1:
        li = _pasm.logical_idx(t)
        y4 = ops.pas_conv2d(case.img, t, g, bias=bias, relu=True)
        p4 = ph.pas_conv_plain(case.img.contiguous(), li, t.codebook, bias,
                               geom=g, relu=True)
        torch.cuda.synchronize()
        e4 = max_err(y4, p4)
        errs["pas_conv"] = max(errs["pas_conv"], e4)
        line += f" K4 {e4:.2e}"
        if k1:
            y3 = ops.pas_matmul(x, t, bias=bias, relu=True, pool=case.pool)
            p3 = ph.pas_matmul_plain(x, li, t.codebook, bias, relu=True,
                                     pool=case.pool)
            torch.cuda.synchronize()
            e3 = max_err(y3, p3)
            errs["pas_matmul"] = max(errs["pas_matmul"], e3)
            same = torch.equal(y3.reshape(y4.shape), y4)
            line += f" K3 {e3:.2e} K3≡K4 {same}"
            if not same:
                raise AssertionError(f"{case.name}: K3 and K4 differ bitwise")
    if not pasm:
        log(line)
        return
    y2 = ops.pasm_conv2d(case.img, t, g, bias=bias, relu=True)
    p2 = pm.pasm_conv_plain(case.img.contiguous(), t.idx, t.codebook, bias,
                            geom=g, packed=t.packed, relu=True)
    torch.cuda.synchronize()
    e2 = max_err(y2, p2)
    errs["pasm_conv"] = max(errs["pasm_conv"], e2)
    line += f" K2 {e2:.2e}"
    if k1:
        y1 = ops.pasm_matmul(x, t, bias=bias, relu=True, pool=case.pool)
        p1 = pm.pasm_matmul_plain(x, t.idx, t.codebook, bias, packed=t.packed,
                                  relu=True, pool=case.pool)
        torch.cuda.synchronize()
        e1 = max_err(y1, p1)
        errs["pasm_matmul"] = max(errs["pasm_matmul"], e1)
        same = torch.equal(y1.reshape(y2.shape), y2)
        line += f" K1 {e1:.2e} K1≡K2 {same}"
        if not same:
            raise AssertionError(f"{case.name}: K1 and K2 differ bitwise")
    log(line)


def check_integer(case: Case, gen) -> None:
    """Paper §5.3: on integer-valued images, dictionaries and biases PASM is
    bit-exact against the weight-shared MAC.  |x|, |cb| <= 8 keeps every
    sum below 2^24 (K <= 3456), so f32 holds it exactly: K3 == K1 and
    K4 == K2 bitwise, whatever order each adds in."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.kernels import ops

    p = case.params
    cb = torch.randint(-8, 9, (p.bins,), generator=gen, device="cuda").float()
    bias = torch.randint(-99, 100, (p.c_out,), generator=gen, device="cuda").float()
    ip = cv.ConvParams.shared(p.idx, cb, bias=bias)
    img = torch.randint(-8, 9, tuple(case.img.shape), generator=gen,
                        device="cuda").float()
    c = dataclasses.replace(case, params=ip, img=img)
    t, g, x = ip.gemm_tensor(c.conv.layout), c.geom(), c.patches()
    y1 = ops.pasm_matmul(x, t, bias=bias, relu=True, pool=c.pool)
    y3 = ops.pas_matmul(x, t, bias=bias, relu=True, pool=c.pool)
    y2 = ops.pasm_conv2d(img, t, g, bias=bias, relu=True)
    y4 = ops.pas_conv2d(img, t, g, bias=bias, relu=True)
    torch.cuda.synchronize()
    ok = (torch.equal(y3, y1) and torch.equal(y4, y2)
          and torch.equal(y1.reshape(y2.shape), y2))
    log(f"  {case.name:<30} integer-valued: K3 == K1, K4 == K2 bitwise {ok} "
        f"(|y| max {float(y1.abs().max()):.0f})")
    if not ok:
        raise AssertionError(f"{case.name}: integer PAS differs from the MAC")


def stage_cases(cfg, qparams, batch: int, gen) -> list:
    """The five full-width stages with the served model's dictionaries."""
    import torch

    from repro_torch.core import conv as cv
    from repro_torch.models import cnn

    C, H, W = cfg.in_chw
    out = []
    for i, ((conv, pool), p) in enumerate(zip(cnn.stages(cfg), qparams["conv"])):
        img = torch.randn((batch, C, H, W), generator=gen, device="cuda")
        out.append(Case(f"conv{i + 1} {C}x{H}x{W}", conv, pool, p, img))
        H, W = cv.conv_out_hw(H, W, conv)
        H, W, C = H // pool, W // pool, conv.c_out
    return out


def bound(case: Case, explicit: bool) -> tuple:
    """(ops_ms, bytes_ms, flops) of one stage launch: the flops over the f32
    peak, and each input byte read once plus the output written once over
    the memory rate; the bound is the larger of the two."""
    g = case.geom()
    t = case.params.gemm_tensor(case.conv.layout)
    B = case.img.shape[0]
    N = t.shape[1]
    flops = 2 * B * g.P_rows * g.conv_k * N
    w_bytes = t.idx.numel() + t.codebook.numel() * 4 + N * 4
    x_bytes = (B * g.P_rows * t.shape[0] * 4) if explicit else case.img.numel() * 4
    nbytes = x_bytes + w_bytes + B * g.P_out * N * 4
    return (flops / (F32_TFLOPS * 1e12) * 1e3, nbytes / (HBM_TBPS * 1e12) * 1e3,
            flops)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F

    from repro_torch.configs import alexnet_conv
    from repro_torch.core import conv as cv
    from repro_torch.core import pasm as _pasm
    from repro_torch.kernels import _build, ops, pas_histogram as ph
    from repro_torch.kernels import pasm_matmul as pm
    from repro_torch.models import cnn
    from repro_torch.serve.batcher import CnnBatcher

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)

    # 1. the card ----------------------------------------------------------
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build ---------------------------------------------------------------
    t_build = _build.build()
    log(f"build: {t_build:.2f} s (nvcc, {len(_build.SOURCES)} sources in parallel)")
    for name in _build.SOURCES:
        for ln in _build.build_log(name).splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"  ptxas {name}: {ln.strip()}")

    # the full-width model: seeded weights, k-means on the card
    cfg = alexnet_conv.config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = cnn.init_params(cfg, gen, device="cuda")
    qparams = cnn.quantize(params, cfg)
    torch.cuda.synchronize()
    log(f"model: {cfg.name} {cfg.in_chw} -> {cfg.classes} classes, "
        f"{cfg.bins} bins, quantized on the card in {time.perf_counter() - t0:.2f} s")
    packed = [p.pack(layout=cfg.layout) for p in qparams["conv"]]

    # 3. kernels vs plain versions -----------------------------------------
    errs = dict.fromkeys(KERNELS, 0.0)
    log(f"phase 3: kernels vs plain versions (tolerance |Δ| <= {TOL} + {TOL}·|plain|)")
    for kind, plist in (("shared", qparams["conv"]), ("packed", packed)):
        for case in stage_cases(cfg, {"conv": plist}, 4, gen):
            case.name = f"{case.name} {kind}"
            check_case(case, errs)
    for case in stage_cases(cfg, qparams, 4, gen):
        check_integer(case, gen)
    third = stage_cases(cfg, qparams, 4, gen)[2]
    kshape = third.params.kshape
    scale = third.params.codebook.std()  # random dictionaries at the served scale
    for bins, top in ((4, 4), (256, 256), (16, 20)):  # 20: indices past 16 bins
        rp = cv.ConvParams.shared(
            torch.randint(0, top, kshape, generator=gen, device="cuda",
                          dtype=torch.uint8),
            torch.randn(bins, generator=gen, device="cuda") * scale,
            bias=third.params.bias)
        check_case(dataclasses.replace(
            third, name=f"{third.name} B={bins} idx<{top}", params=rp), errs,
            pasm=top == bins)  # K1/K2 clamp an index past B: another function
    first, second = stage_cases(cfg, qparams, 4, gen)[:2]
    g2 = cv.ConvParams.quantize(params["conv"][1].kernel, cfg.bins,
                                bias=params["conv"][1].bias, groups=2)
    check_case(dataclasses.replace(second, name=second.name + " groups=2 shared",
                                   params=g2), errs)
    check_case(dataclasses.replace(second, name=second.name + " groups=2 packed",
                                   params=g2.pack()), errs)
    check_case(dataclasses.replace(
        first, name=first.name + " NHWC same packed",
        conv=dataclasses.replace(first.conv, padding="same", layout="NHWC"),
        params=first.params.pack(layout="NHWC"),
        img=first.img.permute(0, 2, 3, 1).contiguous()), errs)
    C0 = cfg.in_chw[0]
    check_case(dataclasses.replace(
        first, name=f"bigimg_conv1 {C0}x512x512",
        img=torch.randn((2, C0, 512, 512), generator=gen, device="cuda")),
        errs, k1=False)

    # 4. serve the full-width model ----------------------------------------
    rng = np.random.default_rng(SEED)
    H, W = cfg.in_chw[1:]
    frac = [(0.9, 0.8), (1.0, 0.67), (0.67, 1.0), (0.57, 0.57), (0.45, 0.54),
            (0.43, 0.29), (0.29, 0.29), (0.27, 0.18), (0.14, 0.14), (0.14, 0.08),
            (0.07, 0.07), (0.04, 0.04)]
    sizes = [(H, W)] * 6 + [(max(1, int(H * a)), max(1, int(W * b))) for a, b in frac]
    images = [rng.standard_normal((3, h, w)).astype(np.float32) for h, w in sizes]
    log(f"phase 4: serving {len(images)} requests of {len(set(sizes))} sizes "
        "through CnnBatcher(device='cuda')")
    served, counts = {}, {}
    for impl in ("kernel", "kernel_implicit", "pas_kernel", "einsum"):
        b = CnnBatcher(dataclasses.replace(cfg, impl=impl), qparams, max_batch=8,
                       device="cuda")
        reqs = [b.submit(im) for im in images]
        torch.cuda.synchronize()
        pm.reset_launches()
        b.flush()
        torch.cuda.synchronize()
        counts[impl] = dict(pm.launches)
        n_stages = len(cfg.layers)
        roll = b.metrics.rollup()
        log(f"  {impl:<16} {b.n_batches} batches, launches {counts[impl]}, "
            f"{roll['img_s']:.1f} img/s host clock incl. first-call overheads "
            f"({card})")
        key = SERVED_KERNEL.get(impl)
        want_counts = {k: n_stages * b.n_batches if k == key else 0
                       for k in KERNELS}
        if counts[impl] != want_counts:
            raise AssertionError(
                f"{impl}: expected launches {want_counts} ({n_stages} per batch "
                f"over {b.n_batches} batches), got {counts[impl]}")
        if not all(r.done and r.logits.shape == (cfg.classes,)
                   and np.isfinite(r.logits).all() for r in reqs):
            raise AssertionError(f"{impl}: a request was not served finite logits")
        served[impl] = np.stack([r.logits for r in reqs])
    want = served["einsum"]
    for impl in SERVED_KERNEL:
        d = np.abs(served[impl] - want)
        agree = float((served[impl].argmax(-1) == want.argmax(-1)).mean())
        log(f"  {impl} logits vs einsum: max|Δ| {d.max():.3e} "
            f"(|logit| max {np.abs(want).max():.3f}), class agreement {agree:.3f}")
        if not np.all(d <= LOGIT_TOL + LOGIT_TOL * np.abs(want)):
            raise AssertionError(f"{impl} logits off the einsum engine")
        if impl == "pas_kernel" and agree != 1.0:
            raise AssertionError(f"{impl} classes differ from the einsum engine")
    log(f"  kernel ≡ kernel_implicit logits bitwise: "
        f"{np.array_equal(served['kernel'], served['kernel_implicit'])}")

    # the five full-width stages through conv2d(engine="pas_kernel_implicit")
    stage_imgs = torch.from_numpy(np.stack(images[:6])).cuda()
    outs = {}
    for engine in ("pas_kernel_implicit", "einsum"):
        torch.cuda.synchronize()
        pm.reset_launches()
        h = stage_imgs
        for p, (conv, pool) in zip(qparams["conv"], cnn.stages(cfg)):
            h = cv.conv2d(h, p, conv, engine=engine, pool=pool)
        outs[engine] = cnn._head(h, qparams["head"])
        torch.cuda.synchronize()
        counts[engine + " stages"] = dict(pm.launches)
    k4_counts = counts["pas_kernel_implicit stages"]
    if k4_counts != {k: n_stages if k == "pas_conv" else 0 for k in KERNELS}:
        raise AssertionError(f"pas_kernel_implicit stages: launches {k4_counts}")
    got, want4 = outs["pas_kernel_implicit"].cpu().numpy(), outs["einsum"].cpu().numpy()
    d = np.abs(got - want4)
    agree = float((got.argmax(-1) == want4.argmax(-1)).mean())
    log(f"  pas_kernel_implicit stages ({len(stage_imgs)} images): launches "
        f"{k4_counts}, logits vs einsum max|Δ| {d.max():.3e}, class agreement "
        f"{agree:.3f}")
    if not (np.all(d <= LOGIT_TOL + LOGIT_TOL * np.abs(want4)) and agree == 1.0):
        raise AssertionError("pas_kernel_implicit stage logits off the einsum engine")

    # 5. timings at batch 32 -------------------------------------------------
    log(f"phase 5: CUDA-event timings at batch {TIME_BATCH} ({card})")
    tot = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "ops_ms": 0.0, "bytes_ms": 0.0} for k in KERNELS}
    for case in stage_cases(cfg, qparams, TIME_BATCH, gen):
        t = case.params.gemm_tensor(case.conv.layout)
        bias, g = case.params.bias, case.geom()
        x = case.patches()
        w = cv.ConvParams.dense_operand(case.params, case.conv.layout)
        kern4 = cv._unflatten_kernel(w[: case.conv.K], "ckk", case.params.kshape)
        kern4 = kern4.contiguous()
        li = _pasm.logical_idx(t)
        rows, lib = [], {}
        for key in KERNELS:
            explicit = key in ("pasm_matmul", "pas_matmul")
            if key == "pas_matmul":
                k_fn = lambda: ops.pas_matmul(x, t, bias=bias, relu=True, pool=case.pool)
                p_fn = lambda: ph.pas_matmul_plain(x, li, t.codebook, bias, relu=True,
                                                   pool=case.pool)
            elif key == "pas_conv":
                k_fn = lambda: ops.pas_conv2d(case.img, t, g, bias=bias, relu=True)
                p_fn = lambda: ph.pas_conv_plain(case.img, li, t.codebook, bias,
                                                 geom=g, relu=True)
            elif explicit:
                k_fn = lambda: ops.pasm_matmul(x, t, bias=bias, relu=True, pool=case.pool)
                p_fn = lambda: pm.pasm_matmul_plain(x, t.idx, t.codebook, bias,
                                                    packed=t.packed, relu=True,
                                                    pool=case.pool)
                l_fn = lambda: torch.matmul(x, w)
            else:
                k_fn = lambda: ops.pasm_conv2d(case.img, t, g, bias=bias, relu=True)
                p_fn = lambda: pm.pasm_conv_plain(case.img, t.idx, t.codebook, bias,
                                                  geom=g, packed=t.packed, relu=True)
                l_fn = lambda: F.conv2d(case.img, kern4, bias, stride=case.conv.stride)
            errs[key] = max(errs[key], max_err(k_fn(), p_fn()))
            ms, plain_ms = time_ms(k_fn), time_ms(p_fn)
            if explicit not in lib:  # one library call per function (K1/K3, K2/K4)
                lib[explicit] = time_ms(l_fn)
            lib_ms = lib[explicit]
            ops_ms, bytes_ms, flops = bound(case, explicit)
            b_ms = max(ops_ms, bytes_ms)
            b_by = "operations" if ops_ms >= bytes_ms else "bytes"
            r = tot[key]
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms), ("ops_ms", ops_ms), ("bytes_ms", bytes_ms)):
                r[k] += v
            rows.append(f"{key} {ms:.4f} ms (plain {plain_ms:.4f}, library "
                        f"{lib_ms:.4f}, bound {b_ms:.4f} by {b_by}, "
                        f"{flops / ms / 1e9:.1f} TFLOP/s)")
        log(f"  {case.name:<18} " + "\n    ".join(rows) + f" [{card}]")

    # 6. the kernels line ------------------------------------------------------
    replaces = {
        "pasm_matmul": "src/repro/kernels/pasm_matmul.py:308",
        "pasm_conv": "src/repro/kernels/pasm_matmul.py:464",
        "pas_matmul": "src/repro/kernels/pas_histogram.py:101",
        "pas_conv": "src/repro/kernels/pas_histogram.py:184",
    }
    launches = {"pasm_matmul": counts["kernel"]["pasm_matmul"],
                "pasm_conv": counts["kernel_implicit"]["pasm_conv"],
                "pas_matmul": counts["pas_kernel"]["pas_matmul"],
                "pas_conv": counts["pas_kernel_implicit stages"]["pas_conv"]}
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the main paths never launched: {launches}")
    kernels = []
    for key in KERNELS:
        r = tot[key]
        kernels.append({
            "name": key,
            "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{key}.cu",
            "replaces": replaces[key],
            "launches": launches[key],
            "max_abs_err": errs[key],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes",
            "library_ms": r["library_ms"],
        })
    log(f"times are sums over the five AlexNet stages at batch {TIME_BATCH}; "
        f"launches are from the serving runs (K1-K3) and the stage run (K4) "
        f"[{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
