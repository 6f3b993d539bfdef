"""Launch wrappers for the two Hopper kernels, and their plain versions.

``y = x @ W`` where ``W`` never exists in device memory: only ``log2(B)``-bit
indices (uint8, or two 4-bit indices per byte) plus a ``(G, B)`` codebook are
read, and each weight tile is dequantized in shared memory.

* **K1** :func:`pasm_matmul_kernel_call` — ``csrc/pasm_matmul.cu``.  Replaces
  the TPU kernel ``repro/kernels/pasm_matmul.py::pasm_matmul_kernel_call``
  (``_kernel`` → ``_fused_dequant_step``).  ``x`` is an explicit ``(M, K)``
  operand: the conv path's im2col patch matrix.
* **K2** :func:`pasm_conv_kernel_call` — ``csrc/pasm_conv.cu``.  Replaces
  ``repro/kernels/pasm_matmul.py::pasm_conv_kernel_call`` (``_conv_kernel``,
  ``patch_tile``, ``_slab_image``, ``_image_specs``): implicit-GEMM conv, the
  patch tile is gathered inside the kernel from the image, so no
  ``(B·P, K)`` patch matrix exists.

**What bounds them on the H100.**  At the AlexNet stage shapes both do
``2·M·K·N`` flops over ``K`` = 363…3456, at least 45 flops per byte they
must move (K1 reads the patch matrix; K2 only the image, so more): above the
f32 ridge (67 TFLOP/s over 3.35 TB/s ≈ 20), so they are bound by f32
operations.  This slice's design is the plain SIMT
answer to that: a 16×16-thread block owns a ``bm × 64`` output tile with the
K loop inside the block; each thread keeps a ``bm/16 × 4`` register tile of
f32 accumulators, so every pair of shared-memory reads feeds
``bm/16 · 4 / (bm/16 + 4)`` FMAs; ``x``/patch and dequantized weight tiles
(16 K rows) are staged in shared memory; the codebook (``G·B`` floats) is
staged once per block and dequant is a shared-memory lookup.  No tensor
cores, no TF32, no TMA yet (ROADMAP Queue 2, K1/K2 speed).

The fused epilogue runs after the K loop: ``+bias``, ReLU, then with
``pool > 1`` the max over each ``pool²`` consecutive (window-major) rows,
through a shared-memory tile.  A block's rows hold whole windows
(``rows = bm - bm % pool²``), so no window straddles two blocks.  The ragged
K edge is masked in-kernel (no tile-plan K pad); the §3 pack-time ``pad_k``
row is part of the data format and is paired with a zero activation.

``gather="take"|"onehot"`` were two TPU lowerings of one function; the port
keeps the argument for signature parity and both run the same shared-memory
lookup.

On a CPU tensor each wrapper runs its plain version
(:func:`pasm_matmul_plain`, :func:`pasm_conv_plain`); on a CUDA tensor it
launches the kernel or raises.  Each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as _ref

__all__ = [
    "ConvGeom",
    "patch_tile",
    "pasm_matmul_kernel_call",
    "pasm_conv_kernel_call",
    "pasm_matmul_plain",
    "pasm_conv_plain",
    "launches",
    "reset_launches",
    "BM_TILES",
    "GATHERS",
    "pool_plan_exists",
]

# the row tiles the CUDA kernels are compiled for (template BM in csrc);
# 256 is only taken when a pool window holds more than 64 rows (pool >= 9),
# which no AlexNet stage does: it is kept so that every window the JAX
# package fuses into its epilogue also fuses here (same conv2d dispatch)
BM_TILES = (64, 256)
GATHERS = ("take", "onehot")


def _pool_row_align(pool: int) -> int:
    """``lcm(pool², 8)`` — the JAX package's pooled-block row alignment."""
    pw = pool * pool
    return pw * 8 // math.gcd(pw, 8)


def pool_plan_exists(pool: int) -> bool:
    """Whether ``conv2d`` fuses a ``pool`` window into the kernel epilogue.

    Kept identical to the JAX package's rule (``lcm(pool², 8) ≤ 256``) so the
    two packages dispatch the same stages to the fused path; every window it
    admits (at most 256 rows) fits one of :data:`BM_TILES`.
    """
    return pool == 1 or _pool_row_align(pool) <= 256


def _pool_bm(pool: int) -> int:
    """The kernels' row tile for a ``pool`` window: 64 rows unless a window
    holds more (then 256).  The C launchers give each block the whole
    windows that fit it (``bm - bm % pool²`` rows)."""
    if not pool_plan_exists(pool):
        raise ValueError(
            f"no pool-aligned tile plan for pool={pool}: use the unfused "
            "max_pool2d fallback (conv2d pool dispatch does this automatically)"
        )
    pw = pool * pool
    return next(bm for bm in BM_TILES if pw <= bm)

# launches of each kernel in this process, K1 and K2 here, K3 and K4 of
# repro_torch.kernels.pas_histogram and K5 of
# repro_torch.kernels.flash_attention too: each wrapper adds one per launch,
# and nowhere else (chip_smoke.py resets them around the main path)
launches = {"pasm_matmul": 0, "pasm_conv": 0, "pas_matmul": 0, "pas_conv": 0,
            "flash_attention": 0}

_NO_GRAD = (
    "the CUDA PASM kernels are forward-only in this slice; autograd "
    "(torch.autograd.Function backwards) arrives with the QAT/training slice, "
    "ROADMAP Queue 1 item 7 — call under torch.no_grad() or detach the inputs"
)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


class ConvGeom(NamedTuple):
    """Static conv geometry the implicit-GEMM kernel takes.

    Built by :func:`repro_torch.core.conv.conv_geom`.  ``pad`` is the
    spatial zero-pad ``((lo_h, hi_h), (lo_w, hi_w))``; K2 applies it as
    masked reads, its plain version pads the image first.  ``pool > 1``
    fuses a non-overlapping ``(pool, pool)`` max-pool: GEMM rows are
    **window-major** (each consecutive ``pool²`` rows one pool window).
    """

    nhwc: bool  # channels-minor (kkc) vs paper (ckk) reduction order
    ky: int
    kx: int
    stride: int
    oh: int
    ow: int
    c_in: int
    pad: tuple
    pool: int = 1

    @property
    def P(self) -> int:
        """Pre-pool output pixels per image."""
        return self.oh * self.ow

    @property
    def conv_k(self) -> int:
        """The true im2col reduction length ``c_in·ky·kx``."""
        return self.c_in * self.ky * self.kx

    @property
    def ohp(self) -> int:
        return self.oh // self.pool

    @property
    def owp(self) -> int:
        return self.ow // self.pool

    @property
    def P_out(self) -> int:
        """Stored output pixels per image (``== P`` when ``pool == 1``)."""
        return self.ohp * self.owp

    @property
    def P_rows(self) -> int:
        """GEMM rows per image: floor-dropped remainder pixels of the
        pre-pool map are never computed."""
        return self.P_out * self.pool * self.pool


def patch_tile(img: torch.Tensor, m0: int, q0: int, *, geom: ConvGeom,
               bm: int, bk: int) -> torch.Tensor:
    """Assemble ``(B, bm, bk)`` im2col tiles from spatially padded images.

    The plain version of K2's gather, with the index decode of the TPU
    kernel's ``patch_tile``.  ``img`` is a padded batch (``(B, Hp, Wp, C)``
    when ``geom.nhwc`` else ``(B, C, Hp, Wp)``); rows are GEMM rows
    ``[m0, m0+bm)``, columns reduction positions ``[q0, q0+bk)``.  Row ``m``
    is offset ``s = m % pool²`` inside pooled pixel ``pp = m // pool²``
    (window-major); rows past the last window clamp to it.  Columns at or
    past ``geom.conv_k`` are the §3 pack-time K-pad and read zero.
    """
    dev = img.device
    m = m0 + torch.arange(bm, device=dev)[:, None]
    pw = geom.pool * geom.pool
    pp = torch.clamp(m // pw, max=geom.P_out - 1)
    s = m % pw
    oy = (pp // geom.owp) * geom.pool + s // geom.pool
    ox = (pp % geom.owp) * geom.pool + s % geom.pool
    q = q0 + torch.arange(bk, device=dev)[None, :]
    valid = q < geom.conv_k
    ql = torch.clamp(q, max=geom.conv_k - 1)
    if geom.nhwc:  # channels-minor (ky, kx, c)
        dy = ql // (geom.kx * geom.c_in)
        dx = (ql // geom.c_in) % geom.kx
        c = ql % geom.c_in
    else:  # paper (c, ky, kx) loop order
        c = ql // (geom.ky * geom.kx)
        dy = (ql // geom.kx) % geom.ky
        dx = ql % geom.kx
    iy = oy * geom.stride + dy  # (bm, bk) via broadcast
    ix = ox * geom.stride + dx
    c = c.expand_as(iy)
    vals = img[:, iy, ix, c] if geom.nhwc else img[:, c, iy, ix]
    return torch.where(valid, vals, torch.zeros((), dtype=img.dtype, device=dev))


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the card oracle)
# ---------------------------------------------------------------------------


def _widen_bf16(x: torch.Tensor, codebook: torch.Tensor) -> tuple:
    """K1's bf16 route: ``x`` widened to f32 and the codebook rounded to
    bf16 and back.  Both steps are exact, and so is every product of two
    bf16 values in f32, so the f32 GEMM computes the JAX kernel's
    ``Σ_k bf16(x)·bf16(cb[idx])`` (it dequantizes each tile to ``x``'s
    dtype and accumulates in f32) up to the order of the sum."""
    if x.dtype != torch.bfloat16:
        return x, codebook
    return x.float(), codebook.to(torch.bfloat16).float()


def pasm_matmul_plain(x, idx, codebook, bias=None, *, packed: bool,
                      relu: bool = False, pool: int = 1) -> torch.Tensor:
    """K1's plain version: dequant GEMM, epilogue, window-major row pool.
    ``x`` is f32 or bf16 (:func:`_widen_bf16`); the result is f32."""
    x, codebook = _widen_bf16(x, codebook)
    y = _ref.pasm_matmul_ref(x, idx, codebook, packed=packed)
    return _ref.max_pool_rows(_ref.apply_epilogue(y, bias, relu), pool)


def _pad_image(x: torch.Tensor, geom: ConvGeom) -> torch.Tensor:
    (plh, phh), (plw, phw) = geom.pad
    if not (plh or phh or plw or phw):
        return x
    cfg = (0, 0, plw, phw, plh, phh) if geom.nhwc else (plw, phw, plh, phh)
    return F.pad(x, cfg)


def pasm_conv_plain(x, idx, codebook, bias=None, *, geom: ConvGeom,
                    packed: bool, relu: bool = False) -> torch.Tensor:
    """K2's plain version: pad, gather every patch row with
    :func:`patch_tile`, then K1's plain version.  ``(B, P_out, N)``."""
    Kp = idx.shape[0] * (2 if packed else 1)
    batch = x.shape[0]
    patches = patch_tile(_pad_image(x, geom), 0, 0, geom=geom,
                         bm=geom.P_rows, bk=Kp)
    y = pasm_matmul_plain(patches.reshape(batch * geom.P_rows, Kp), idx,
                          codebook, bias, packed=packed, relu=relu,
                          pool=geom.pool)
    return y.reshape(batch, geom.P_out, -1)


# ---------------------------------------------------------------------------
# launch wrappers
# ---------------------------------------------------------------------------


def _check_operands(x, idx, codebook, bias, *, packed: bool, gather: str,
                    k_rows: int) -> None:
    """Device, dtype, shape and contiguity checks shared by K1 and K2."""
    if gather not in GATHERS:
        raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
    ts = [t for t in (x, idx, codebook, bias) if t is not None]
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError(_NO_GRAD)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in ts]}")
    if x.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise TypeError(f"x and codebook must be float32, got {x.dtype}, {codebook.dtype}")
    if idx.dtype != torch.uint8 or idx.ndim != 2:
        raise TypeError(f"idx must be 2-D uint8, got {idx.dtype} {tuple(idx.shape)}")
    if codebook.ndim != 2:
        raise ValueError(f"codebook must be (G, B), got {tuple(codebook.shape)}")
    K = idx.shape[0] * (2 if packed else 1)
    if K != k_rows:
        raise ValueError(f"idx holds {K} reduction rows, the activation {k_rows}")
    if K % codebook.shape[0]:
        raise ValueError(f"K={K} not divisible by codebook groups={codebook.shape[0]}")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (idx.shape[1],)):
        raise ValueError(f"bias must be float32 ({idx.shape[1]},), got "
                         f"{bias.dtype} {tuple(bias.shape)}")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA kernels take contiguous tensors")


def _check_image(x: torch.Tensor, geom: ConvGeom, Kp: int) -> tuple:
    """The implicit-GEMM kernels' image checks (K2, K4); returns ``(C, H, W)``."""
    if x.ndim != 4:
        raise ValueError(f"x must be a 4-D image batch, got {tuple(x.shape)}")
    if x.shape[0] > 65535:  # the launch grid's z extent
        raise ValueError(f"the conv kernels take at most 65535 images per "
                         f"call, got {x.shape[0]}")
    C, H, W = (x.shape[3], x.shape[1], x.shape[2]) if geom.nhwc \
        else (x.shape[1], x.shape[2], x.shape[3])
    (plh, phh), (plw, phw) = geom.pad
    if C != geom.c_in or Kp - geom.conv_k not in (0, 1):
        raise ValueError(f"image {tuple(x.shape)} / K={Kp} do not match {geom}")
    if (geom.oh - 1) * geom.stride + geom.ky > H + plh + phh or \
            (geom.ow - 1) * geom.stride + geom.kx > W + plw + phw:
        raise ValueError(f"image {tuple(x.shape)} too small for {geom}")
    return C, H, W


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name()})"
        )


_P, _I = ctypes.c_void_p, ctypes.c_int


def pasm_matmul_kernel_call(
    x: torch.Tensor,
    idx: torch.Tensor,
    codebook: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    packed: bool,
    relu: bool = False,
    pool: int = 1,
    gather: str = "take",
) -> torch.Tensor:
    """K1: ``x (M, K) · idx (K or K/2, N) · codebook (G, B) → (M/pool², N)``.

    ``bias (N,)`` and ``relu`` are the fused epilogue; ``pool > 1`` expects
    window-major rows (``M % pool² == 0``) and stores the pooled map.  The
    row tile follows from ``pool`` (:func:`_pool_bm`).  ``x`` is f32 or
    bf16: a bf16 ``x`` runs the f32 kernel on exact widenings
    (:func:`_widen_bf16`).  The output is f32.
    """
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got {tuple(x.shape)}")
    x, codebook = _widen_bf16(x, codebook)
    _check_operands(x, idx, codebook, bias, packed=packed, gather=gather,
                    k_rows=x.shape[1])
    M, K = x.shape
    N = idx.shape[1]
    pw = pool * pool
    if M % pw:
        raise ValueError(f"pool={pool} needs window-major rows, M={M} % {pw}")
    bm = _pool_bm(pool)
    if x.device.type == "cpu":
        return pasm_matmul_plain(x, idx, codebook, bias, packed=packed,
                                 relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"no PASM kernel for device {x.device}")
    out = torch.empty((M // pw, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels import _build

    fn = _build.entry_point("pasm_matmul", "pasm_matmul_launch",
                            [_P] * 5 + [_I] * 9 + [_P])
    G, B = codebook.shape
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                 M, K, N, G, B, int(packed), int(relu), pool, bm,
                 _stream(x.device))
    _raise_on(err, "pasm_matmul")
    launches["pasm_matmul"] += 1
    return out


def pasm_conv_kernel_call(
    x: torch.Tensor,
    idx: torch.Tensor,
    codebook: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    geom: ConvGeom,
    packed: bool,
    relu: bool = False,
    gather: str = "take",
) -> torch.Tensor:
    """K2: implicit-GEMM conv, ``x (B, C, H, W)`` or ``(B, H, W, C)`` →
    ``(B, P_out, N)`` f32.  The row tile follows from ``geom.pool``.

    ``x`` is the UNPADDED image batch: ``geom.pad`` is applied as masked
    zero reads inside the kernel (the TPU kernel took a padded image).
    ``idx`` holds ``Kp >= geom.conv_k`` reduction rows; positions past
    ``conv_k`` (the §3 pack-time pad) pair with zero activations.
    """
    Kp = idx.shape[0] * (2 if packed else 1) if idx.ndim == 2 else -1
    _check_operands(x, idx, codebook, bias, packed=packed, gather=gather,
                    k_rows=Kp)
    batch = x.shape[0]
    C, H, W = _check_image(x, geom, Kp)
    bm = _pool_bm(geom.pool)
    if x.device.type == "cpu":
        return pasm_conv_plain(x, idx, codebook, bias, geom=geom,
                               packed=packed, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"no PASM kernel for device {x.device}")
    N = idx.shape[1]
    out = torch.empty((batch, geom.P_out, N), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import _build

    fn = _build.entry_point("pasm_conv", "pasm_conv_launch",
                            [_P] * 5 + [_I] * 21 + [_P])
    G, B = codebook.shape
    (plh, _), (plw, _) = geom.pad
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                 batch, C, H, W, int(geom.nhwc), geom.ky, geom.kx, geom.stride,
                 plh, plw, geom.ow, geom.pool, geom.P_out, geom.conv_k, Kp,
                 N, G, B, int(packed), int(relu), bm, _stream(x.device))
    _raise_on(err, "pasm_conv")
    launches["pasm_conv"] += 1
    return out
