"""Launch wrappers for the two paper-faithful PAS kernels, and their plain versions.

The paper's two-phase PASM (§2.2): a PAS phase that only adds,
``S[m, n, b] = Σ_{k : idx[k, n] = b} x[m, k]`` (the weighted histogram of the
dictionary indices), then one post-pass multiply per bin,
``y[m, n] = Σ_b S[m, n, b]·cb[b]``, with the bias/ReLU/window-max epilogue
riding the post-pass.  One dictionary per layer (``G == 1``) and unpacked
uint8 indices, as on the TPU.

* **K3** :func:`pas_matmul_kernel_call` — ``csrc/pas_matmul.cu``.  Replaces
  ``repro/kernels/pas_histogram.py::pas_matmul_kernel_call`` (``_kernel`` →
  ``_pas_step``).  ``x`` is an explicit ``(M, K)`` operand: the conv path's
  im2col patch matrix, or a dense layer's activations.
* **K4** :func:`pas_conv_kernel_call` — ``csrc/pas_conv.cu``.  Replaces
  ``repro/kernels/pas_histogram.py::pas_conv_kernel_call`` (``_conv_kernel``):
  K3's PAS phase and post-pass on K2's in-kernel patch gather.

**How they run on the H100** (``csrc/pas_common.cuh``).  A faithful PAS
phase is a data-chosen add per ``(m, k, n)``.  Lanes run over rows and warps
over columns, so every lane of a warp adds into the same bin at each ``k``:
the 16 bins of a lane's 4 rows are registers, and for each bin a ballot
gives the stage's ``k`` rows in it, which the warp walks in increasing
``k`` (no branch on the bin, no shared-memory bins).  :func:`pas_plan` picks
the tile (128 rows x 16 columns, or 256 x 8 for windows of more than 128
rows), the passes of 16 bins and a split-K count from ``K`` and ``N`` alone;
split partials are added in order by a second pass, so a row's result never
depends on ``M``.

**What bounds them.**  Issue and latency in the walk (about 11
instructions a warp per ``k`` for 128 adds), then the stage loads where one
stage of adds does not hide them; K4's in-kernel gather costs more than K3's
16-byte loads.  ``kernels/ablation.py`` times the kernels with the walk
or the loads taken out; PERF.md has the numbers.

An index ``>= B`` adds nothing in the kernels and in the plain versions, as
the JAX reference's one-hot does (K1/K2 clamp it instead: a different
function).  Both kernels walk ``K`` in the same stages and add into each bin
in the same order, so K3 over the window-major patches equals K4 bitwise.

On a CPU tensor each wrapper runs its plain version (:func:`pas_matmul_plain`,
:func:`pas_conv_plain`); on a CUDA tensor it launches the kernel or raises.
Each launch adds one to ``repro_torch.kernels.pasm_matmul.launches``
(keys ``"pas_matmul"``, ``"pas_conv"``), the one counter dict of all four
kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.pasm_matmul import (
    _I,
    _P,
    HALF,
    ConvGeom,
    _cdiv,
    _check_image,
    _check_operands,
    _pad_image,
    _ptr,
    _raise_on,
    _stream,
    launches,
    patch_tile,
    pool_plan_exists,
)

__all__ = [
    "pas_matmul_kernel_call",
    "pas_conv_kernel_call",
    "pas_matmul_plain",
    "pas_conv_plain",
    "PasPlan",
    "pas_plan",
]

_L = ctypes.c_longlong

# the block of csrc/pas_common.cuh: 16 warps, a warp 128 rows x 1 column;
# the warps stand 1 x 16 (128 x 16 outputs) or, for windows of more than
# 128 rows, 2 x 8 (256 x 8).  Row tile -> block columns:
PAS_TILES = {128: 16, 256: 8}
PAS_BINS = 16  # bins per pass (register accumulators per row)
PAS_BK = 32  # reduction rows per stage (one per lane)
PAS_SPLIT_K = 1536  # K rows per split-K partition (at least)
PAS_SPLIT_MAX_N = 512  # split K only up to this many columns
# GEMM rows of one launch (csrc PAS_MAX_M: rows are ints in the kernels, up
# to a tile below 2^31); K4 splits a larger batch into launches of whole
# images, which give the same rows (a row's result does not depend on M)
PAS_MAX_M = 0x7FFFFFFF - 256

_NO_GRAD = (
    "the PAS kernels are forward-only, as the TPU kernels they replace are: "
    "call under torch.no_grad() or detach the inputs"
)


class PasPlan(NamedTuple):
    """How K3/K4 run one call: the row tile (128 or 256) and the rows a
    block owns (whole pool windows), the columns per block, the passes of
    :data:`PAS_BINS` bins, the split-K count, the blocks launched and the
    f32 elements of split-K scratch (0 without split-K)."""

    tile: int
    rows: int
    cols: int
    passes: int
    splits: int
    blocks: int
    scratch: int


def pas_plan(M: int, K: int, N: int, B: int, pool: int = 1, *,
             whole: Optional[tuple] = None) -> PasPlan:
    """K3/K4's launch for ``x (M, K) · idx (K, N)`` over ``B`` bins (K4: the
    ``M = batch · P_rows`` rows of the implicit patch matrix, image after
    image) — a pure function of the shapes.

    The row tile is 128 unless a ``pool`` window holds more rows (then 256,
    with 8 columns a block); a block owns ``tile - tile % pool²`` rows.  The
    split-K count depends on K and N only, so a row sums in the same order
    whatever M is: a layer of at most :data:`PAS_SPLIT_MAX_N` columns splits
    K into parts of at least :data:`PAS_SPLIT_K` rows (measured on the H100:
    conv4 and conv5 of AlexNet, K = 3456, gain from 2 splits; conv2 and
    conv3, K = 2400 and 2304, lose).  ``whole = (M, N)`` of the unsharded
    call, for one rank's block of it: the split count follows the whole N
    (``pasm_matmul.simt_plan``'s rule).
    """
    if not pool_plan_exists(pool):
        raise ValueError(
            f"no pool-aligned tile plan for pool={pool}: use the unfused "
            "max_pool2d fallback (conv2d pool dispatch does this automatically)"
        )
    pw = pool * pool
    tile = next(t for t in PAS_TILES if pw <= t)
    cols = PAS_TILES[tile]
    rows = tile - tile % pw
    wn = N if whole is None else whole[1]
    splits = max(1, K // PAS_SPLIT_K) if wn <= PAS_SPLIT_MAX_N else 1
    blocks = _cdiv(M, rows) * _cdiv(N, cols) * splits
    return PasPlan(tile, rows, cols, _cdiv(B, PAS_BINS), splits, blocks,
                   splits * M * N if splits > 1 else 0)


def _widen_x(x: torch.Tensor) -> torch.Tensor:
    """A bf16 or f16 activation as its exact f32 widening: the PAS phase
    sums f32 activations into its bins."""
    return x.float() if x.dtype in HALF else x


def _check_pas(x, idx, codebook, bias, k_rows: int) -> None:
    """K3/K4 operand checks: forward only, one dictionary of at most 256
    bins, unpacked indices, then K1/K2's device/dtype/shape checks."""
    ts = [t for t in (x, idx, codebook, bias) if t is not None]
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError(_NO_GRAD)
    if codebook.ndim != 2 or codebook.shape[0] != 1:
        raise ValueError(
            "the PAS kernels are paper-faithful: one dictionary, codebook "
            f"(1, B); got {tuple(codebook.shape)}")
    if not 1 <= codebook.shape[1] <= 256:
        raise ValueError(f"uint8 indices address 1..256 bins, got {codebook.shape[1]}")
    _check_operands(x, idx, codebook, bias, packed=False, gather="take",
                    k_rows=k_rows)


# ---------------------------------------------------------------------------
# plain versions (the CPU path and the card oracle)
# ---------------------------------------------------------------------------


def pas_matmul_plain(x, idx, codebook, bias=None, *, relu: bool = False,
                     pool: int = 1) -> torch.Tensor:
    """K3's plain version: one-hot PAS bins, post-pass, epilogue, row pool."""
    y = _ref.pas_matmul_ref(x, idx, codebook)
    return _ref.max_pool_rows(_ref.apply_epilogue(y, bias, relu), pool)


def pas_conv_plain(x, idx, codebook, bias=None, *, geom: ConvGeom,
                   relu: bool = False) -> torch.Tensor:
    """K4's plain version: pad, gather every patch row with
    :func:`~repro_torch.kernels.pasm_matmul.patch_tile`, then K3's plain
    version.  ``(B, P_out, N)``."""
    Kp = idx.shape[0]
    batch = x.shape[0]
    patches = patch_tile(_pad_image(x, geom), 0, 0, geom=geom,
                         bm=geom.P_rows, bk=Kp)
    y = pas_matmul_plain(patches.reshape(batch * geom.P_rows, Kp), idx,
                         codebook, bias, relu=relu, pool=geom.pool)
    return y.reshape(batch, geom.P_out, -1)


# ---------------------------------------------------------------------------
# launch wrappers
# ---------------------------------------------------------------------------


def pas_matmul_kernel_call(
    x: torch.Tensor,
    idx: torch.Tensor,
    codebook: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    relu: bool = False,
    pool: int = 1,
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """K3: ``x (M, K) · idx (K, N) · codebook (1, B) → (M/pool², N)`` f32.

    ``bias (N,)`` and ``relu`` ride the post-pass; ``pool > 1`` expects
    window-major rows (``M % pool² == 0``) and stores the pooled map.  The
    row tile follows from ``pool``.  A bf16 or f16 ``x`` is summed as its
    exact f32 widening, as the JAX kernel sums it.  ``whole``: the unsharded
    call's ``(M, N)`` (:func:`pas_plan`).
    """
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got {tuple(x.shape)}")
    x = _widen_x(x)
    _check_pas(x, idx, codebook, bias, k_rows=x.shape[1])
    M, K = x.shape
    N = idx.shape[1]
    pw = pool * pool
    if M % pw:
        raise ValueError(f"pool={pool} needs window-major rows, M={M} % {pw}")
    B = codebook.shape[1]
    plan = pas_plan(M, K, N, B, pool, whole=whole)
    if x.device.type == "cpu":
        return pas_matmul_plain(x, idx, codebook, bias, relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"no PAS kernel for device {x.device}")
    out = torch.empty((M // pw, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels import _build

    part = torch.empty(plan.scratch, dtype=torch.float32,
                       device=x.device) if plan.scratch else None
    fn = _build.entry_point("pas_matmul", "pas_matmul_launch",
                            [_P] * 6 + [_L] + [_I] * 7 + [_P])
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                 _ptr(part), M, K, N, B, int(relu), pool, plan.tile,
                 plan.splits, _stream(x.device))
    _raise_on(err, "pas_matmul")
    launches["pas_matmul"] += 1
    return out


def pas_conv_kernel_call(
    x: torch.Tensor,
    idx: torch.Tensor,
    codebook: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    *,
    geom: ConvGeom,
    relu: bool = False,
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """K4: implicit-GEMM PAS conv, ``x (B, C, H, W)`` or ``(B, H, W, C)`` →
    ``(B, P_out, N)`` f32.  The row tile follows from ``geom.pool``; a bf16
    or f16 ``x`` runs on its exact f32 widening, and ``whole`` is the
    unsharded call's ``(M, N)``, as in K3.

    ``x`` is the UNPADDED image batch (``geom.pad`` is a masked read, as in
    K2).  ``idx (Kp, N)`` holds ``Kp >= geom.conv_k`` unpacked reduction
    rows; positions past ``conv_k`` (the §3 pack-time pad) pair with zero
    activations.  A batch of more than :data:`PAS_MAX_M` GEMM rows runs as
    several launches of whole images (each counts as a launch).
    """
    Kp = idx.shape[0] if idx.ndim == 2 else -1
    x = _widen_x(x)
    _check_pas(x, idx, codebook, bias, k_rows=Kp)
    batch = x.shape[0]
    C, H, W = _check_image(x, geom, Kp)
    N, B = idx.shape[1], codebook.shape[1]
    plan = pas_plan(batch * geom.P_rows, Kp, N, B, geom.pool, whole=whole)
    if x.device.type == "cpu":
        return pas_conv_plain(x, idx, codebook, bias, geom=geom, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"no PAS kernel for device {x.device}")
    out = torch.empty((batch, geom.P_out, N), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import _build

    fn = _build.entry_point("pas_conv", "pas_conv_launch",
                            [_P] * 6 + [_I] * 20 + [_P])
    (plh, _), (plw, _) = geom.pad
    per = max(1, PAS_MAX_M // geom.P_rows)  # images a launch
    for b0 in range(0, batch, per):
        nb = min(per, batch - b0)
        part = torch.empty(plan.splits * nb * geom.P_rows * N,
                           dtype=torch.float32, device=x.device) \
            if plan.scratch else None
        with torch.cuda.device(x.device):
            err = fn(_ptr(x[b0:]), _ptr(idx), _ptr(codebook), _ptr(bias),
                     _ptr(out[b0:]), _ptr(part), nb, C, H, W, int(geom.nhwc),
                     geom.ky, geom.kx, geom.stride, plh, plw, geom.ow,
                     geom.pool, geom.P_out, geom.conv_k, Kp, N, B, int(relu),
                     plan.tile, plan.splits, _stream(x.device))
        _raise_on(err, "pas_conv")
        launches["pas_conv"] += 1
    return out
