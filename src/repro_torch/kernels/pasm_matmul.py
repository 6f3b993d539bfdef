"""Launch wrappers for K1 and K2 on Hopper, and their plain versions.

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
operations, and the design spends as few other instructions as it can per
FMA (``csrc/pasm_common.cuh``, one device body for both):

* a 256-thread block owns a 128-row tile (256 when a pool window holds more
  than 128 rows: :data:`BM_TILES`) by 64, 96 or 128 columns, picked from N
  by :func:`simt_plan`; a thread holds 8 rows × 8 (6, 4) columns of f32
  accumulators in two 4-wide halves, so one stage of 16 k costs it 64
  conflict-free 16-byte shared reads for 1024 FMAs;
* x (K1: rows of the patch matrix in 16-byte copies where ``K % 4 == 0``,
  else 4-byte ones; K2: the patch rows gathered from the image) and the
  index bytes arrive by ``cp.async`` in a 3-stage ring, one barrier a
  stage; each index stage is dequantized once into an f32 weight tile
  through the shared codebook (``G·B`` floats, staged once per block);
* K2's rows run over the whole batch (row ``m``: pixel ``m % P_rows`` of
  image ``m // P_rows``), and a block decodes its rows' origins and its
  columns' ``(c, dy, dx)`` once into shared tables, so an element is an add
  and a bounds test;
* split-K by K and N only (:func:`simt_plan`: AlexNet's conv3–conv5 split
  4, 6 and 6 ways) fills the card where M is short; partials go to a
  ``torch.empty`` scratch and a second pass adds them in split order.

No tensor cores and no TF32: every output is one f32 ``fmaf`` chain in
ascending k a split, so an unsplit output is bitwise that of the 64 × 64
design this replaced, and K1 ≡ K2 bitwise.

The fused epilogue runs after the K loop (or in the split-K pass): ``+bias``,
ReLU, then with ``pool > 1`` the max over each ``pool²`` consecutive
(window-major) rows, through a shared-memory tile.  A block's rows hold
whole windows (``rows = bm - bm % pool²``), so no window straddles two
blocks.  The ragged K edge is masked in-kernel (no tile-plan K pad); the §3
pack-time ``pad_k`` row is part of the data format and is paired with a
zero activation.

**K1's bf16 routes** (``csrc/pasm_matmul_bf16.cu``).  A bf16 ``x`` is the LM's
activation, and there the SIMT kernel above loses: its 128-row tile computes
128 rows for a decode step's 4, and it has no tensor cores at prefill.
:func:`k1_plan` picks one of three routes from the shapes and dtype alone:

* ``simt`` — f32 ``x``, any fused pool, and what the bf16 routes' tables do
  not hold (more than :data:`MAX_BF16_GROUPS` dictionaries, or packed bytes
  whose two rows fall in two dictionaries): the f32 kernel above, with the
  tile and split-K of :func:`simt_plan` (K1 ≡ K2 bitwise).  A bf16 ``x`` is
  widened to it exactly (:func:`_widen`), and so is an f16 one: no bf16
  route takes f16, and the JAX kernels accept it.
* ``stream`` — bf16, ``M <= STREAM_MAX_M`` (decode): a warp streams 128
  index columns with 16-byte loads straight into tensor-core A fragments
  (one pair-table lookup a byte), ``x`` is an 8- or 16-row B tile, and
  split-K (a count fixed by K and N) fills the card; a second pass adds the
  partial sums in split order (no float atomics).  Bound by the index
  bytes.
* ``mma`` — bf16, ``M > STREAM_MAX_M`` (prefill): the same dequant into A
  fragments on ``BM × 256`` tiles, ``x`` and index tiles through a
  ``cp.async`` ring.  Bound by operations.

Both bf16 routes compute the JAX kernel's products exactly (bf16 × bf16 in
f32) and sum each output row in an order set by K, N and the route, never by
M, so a row computed in a batch equals it computed alone, bitwise.

``gather="take"|"onehot"`` were two TPU lowerings of one function; the port
keeps the argument for signature parity and both run the same shared-memory
lookup.

On a CPU tensor each wrapper runs its plain version
(:func:`pasm_matmul_plain`, :func:`pasm_conv_plain`); on a CUDA tensor it
launches the kernel or raises.  Each launch adds one to :data:`launches`.
"""
from __future__ import annotations

import contextlib
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
    "K1Plan",
    "k1_plan",
    "simt_plan",
    "K1_ROUTES",
    "k1_routes",
]

# the row tiles of K1 simt and K2 (csrc/pasm_common.cuh, template BM): 128,
# or 256 when a pool window holds more than 128 rows (pool 12 and 16), which
# no AlexNet stage does: it is kept so that every window the JAX package
# fuses into its epilogue also fuses here (same conv2d dispatch)
BM_TILES = (128, 256)
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
    """K1 simt's and K2's row tile for a ``pool`` window: 128 rows unless a
    window holds more (then 256).  The C launchers give each block the
    whole windows that fit it (``bm - bm % pool²`` rows)."""
    if not pool_plan_exists(pool):
        raise ValueError(
            f"no pool-aligned tile plan for pool={pool}: use the unfused "
            "max_pool2d fallback (conv2d pool dispatch does this automatically)"
        )
    pw = pool * pool
    return next(bm for bm in BM_TILES if pw <= bm)

# launches of each kernel in this process, K1 and K2 here, K3 and K4 of
# repro_torch.kernels.pas_histogram, K5 of repro_torch.kernels.flash_attention
# and K6 of repro_torch.kernels.decode_attention too: each wrapper adds one
# per launch, and nowhere else (chip_smoke.py resets them around the main path)
launches = {"pasm_matmul": 0, "pasm_conv": 0, "pas_matmul": 0, "pas_conv": 0,
            "flash_attention": 0, "decode_attention": 0}

_NO_GRAD = (
    "the K1/K2 launch wrappers are forward-only: differentiate through "
    "repro_torch.kernels.ops.pasm_matmul / pasm_conv2d (their "
    "torch.autograd.Function backwards), or call under torch.no_grad() or "
    "detach the inputs"
)


K1_ROUTES = ("simt", "stream", "mma")
# K1 launches by route (each also counts once in launches["pasm_matmul"])
k1_routes = dict.fromkeys(K1_ROUTES, 0)


def reset_launches() -> None:
    """Set every launch count to 0."""
    for d in (launches, k1_routes):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# K1's route plan
# ---------------------------------------------------------------------------

SMS = 132  # the H100 SXM's streaming multiprocessors: the fill target
# M0: a bf16 x of at most this many rows takes `stream`, more take `mma`
STREAM_MAX_M = 16
STREAM_COLS = 128  # columns per stream block (csrc S_BN)
STREAM_ROWS = (8, 16)  # rows of x per stream block (csrc 8 x template NT)
MMA_BM, MMA_BN = 64, 256  # the mma block's output tile (csrc BM, BN)
MAX_BF16_GROUPS = 2  # dictionaries the bf16 routes' tables hold (csrc MAX_GROUPS)
MIN_SPLIT_K = 1024  # least K rows per split-K partition
# the bf16 routes against pasm_matmul_plain: the same exact products summed
# in another order (tensor-core accumulation): |Δ| <= K1_BF16_TOL·(|x|@|W|) + 1e-6
K1_BF16_TOL = 1e-5


# K1 simt and K2 (csrc/pasm_common.cuh): the column tiles (a thread holds
# 8 rows x 8, 6 or 4 columns; the 256-row tile takes 64) and split-K: a
# layer of at most SIMT_SPLIT_MAX_N columns whose weight matrix holds at
# least SIMT_SPLIT_MIN_KN entries splits K into parts of at least
# SIMT_SPLIT_K rows, at most SIMT_MAX_SPLITS of them
SIMT_BNS = (128, 96, 64)
SIMT_SPLIT_K = 576
SIMT_MAX_SPLITS = 8
SIMT_SPLIT_MIN_KN = 3 << 18
SIMT_SPLIT_MAX_N = 512


class K1Plan(NamedTuple):
    """How K1 (or K2) runs one call: ``route`` (one of :data:`K1_ROUTES`),
    the split-K count, the block's row tile (``simt``: 128/256 by pool;
    ``stream``: rows of x per block; ``mma``: BM) and column tile, the
    blocks launched, and the f32 elements of split-K scratch the wrapper
    allocates (0 without split-K)."""

    route: str
    splits: int
    tile: int
    cols: int
    blocks: int
    scratch: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def simt_plan(M: int, K: int, N: int, pool: int = 1, *,
              whole: Optional[tuple] = None) -> K1Plan:
    """K1 simt's and K2's launch for ``x (M, K) · W (K, N)`` (K2: the
    ``M = batch · P_rows`` rows of the implicit patch matrix, image after
    image) — a pure function of the shapes.

    The row tile follows from ``pool`` (:func:`_pool_bm`); a block owns
    ``tile - tile % pool²`` rows.  The column tile is the one of
    :data:`SIMT_BNS` that pads N least (the larger on a tie), 64 on the
    256-row tile.  The split-K count depends on K and N only, so every
    output is one ascending-k ``fmaf`` chain a split, in the same order
    whatever M is: the late stages of a CNN, whose weight matrices are large
    and whose maps are small, split (AlexNet's conv3–conv5 at K = 2304 and
    3456: 4, 6 and 6 parts); conv1 and conv2 do not.

    ``whole = (M, N)`` of the unsharded call, for a launch on one rank's
    block of it: the split count follows the whole N, so a shard sums each
    output in the single-device order (a ``model`` shard of conv3 has N 192,
    which alone would not split); the tile and blocks follow the local
    shape.  Without ``whole`` the plan is the single-device one.
    """
    bm = _pool_bm(pool)
    rows = bm - bm % (pool * pool)
    bn = 64 if bm > BM_TILES[0] else \
        min(SIMT_BNS, key=lambda b: (_cdiv(N, b) * b, -b))
    wn = N if whole is None else whole[1]
    splits = 1
    if K * wn >= SIMT_SPLIT_MIN_KN and wn <= SIMT_SPLIT_MAX_N:
        splits = max(1, min(SIMT_MAX_SPLITS, K // SIMT_SPLIT_K))
    return K1Plan("simt", splits, bm, bn,
                  _cdiv(M, rows) * _cdiv(N, bn) * splits,
                  splits * M * N if splits > 1 else 0)


def k1_plan(M: int, K: int, N: int, dtype: torch.dtype, pool: int = 1, *,
            packed: bool = False, groups: int = 1,
            whole: Optional[tuple] = None) -> K1Plan:
    """K1's route for ``x (M, K) · W (K, N)`` over ``groups`` dictionaries
    (``packed``: two int4 indices a byte) — a pure function of the shapes
    and ``x``'s dtype.

    f32, ``pool > 1``, more than :data:`MAX_BF16_GROUPS` dictionaries, and
    packed bytes whose two K rows fall in two dictionaries (odd ``K /
    groups``) take ``simt`` (:func:`simt_plan`); any other bf16 ``x``
    takes ``stream`` up to :data:`STREAM_MAX_M` rows, ``mma`` above.  The
    split-K count of every route depends on K and N only (so a row sums in
    the same order whatever M is); on the bf16 routes it is enough splits
    to fill the SMs, each at least :data:`MIN_SPLIT_K` K rows.

    ``whole = (M, N)`` of the unsharded call (a rank's block of it): the
    route follows the whole M and the split count the whole N, as in
    :func:`simt_plan`, so a shard computes the single-device function.
    """
    if dtype != torch.bfloat16 or pool > 1 or \
            not 0 < groups <= MAX_BF16_GROUPS or (packed and (K // groups) % 2):
        return simt_plan(M, K, N, pool, whole=whole)
    wm, wn = (M, N) if whole is None else whole
    route = "stream" if wm <= STREAM_MAX_M else "mma"
    cols = _cdiv(N, STREAM_COLS if route == "stream" else MMA_BN)
    # split-K by K and N only, to about 1.5 blocks an SM on stream (measured
    # at M = 4, H100: wq 3, w1 1, w2 5 splits are the fastest) and one on
    # mma, whose blocks are heavier and which has M / 64 row blocks besides
    want = (3 * SMS // 2) if route == "stream" else SMS
    wcols = _cdiv(wn, STREAM_COLS if route == "stream" else MMA_BN)
    splits = max(1, min((2 * want + wcols) // (2 * wcols), K // MIN_SPLIT_K))
    if route == "stream":
        tile = STREAM_ROWS[0] if M <= STREAM_ROWS[0] else STREAM_ROWS[1]
    else:
        tile = MMA_BM
    return K1Plan(route, splits, tile,
                  STREAM_COLS if route == "stream" else MMA_BN,
                  cols * splits * _cdiv(M, tile),
                  splits * M * N if splits > 1 else 0)


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


HALF = (torch.bfloat16, torch.float16)


def _widen(x: torch.Tensor, codebook: torch.Tensor) -> tuple:
    """A bf16 or f16 ``x`` onto the f32 route: ``x`` widened to f32 and the
    codebook rounded to ``x``'s dtype and back.  Both steps are exact, and
    so is every product of two such values in f32, so the f32 GEMM computes
    the JAX kernel's ``Σ_k x·cb[idx]`` (it dequantizes each tile to ``x``'s
    dtype and accumulates in f32) up to the order of the sum.  An f32 ``x``
    passes unchanged."""
    if x.dtype not in HALF:
        return x, codebook
    return x.float(), codebook.to(x.dtype).float()


def pasm_matmul_plain(x, idx, codebook, bias=None, *, packed: bool,
                      relu: bool = False, pool: int = 1) -> torch.Tensor:
    """K1's plain version: dequant GEMM, epilogue, window-major row pool.
    ``x`` is f32, bf16 or f16 (:func:`_widen`); the result is f32."""
    x, codebook = _widen(x, codebook)
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
    x, codebook = _widen(x, codebook)
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
                    k_rows: int, x_dtype: torch.dtype = torch.float32) -> None:
    """Device, dtype, shape and contiguity checks shared by K1 and K2."""
    if gather not in GATHERS:
        raise ValueError(f"gather must be one of {GATHERS}, got {gather!r}")
    ts = [t for t in (x, idx, codebook, bias) if t is not None]
    if any(t.requires_grad for t in ts) and torch.is_grad_enabled():
        raise RuntimeError(_NO_GRAD)
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"operands on different devices: {[str(t.device) for t in ts]}")
    if x.dtype != x_dtype or codebook.dtype != torch.float32:
        raise TypeError(f"x must be {x_dtype} and codebook float32, got "
                        f"{x.dtype}, {codebook.dtype}")
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
    """The current CUDA stream of ``dev`` as a raw handle (the call
    PyTorch's own kernel launchers use: no Stream object is built)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


def _on(dev: torch.device):
    """The C launchers launch on the calling thread's current device: make it
    ``dev`` (a no-op context when it already is, which skips two device
    switches on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(
            f"{what} kernel launch failed: cudaError {err} "
            f"({torch.cuda.get_device_name()})"
        )


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


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
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """K1: ``x (M, K) · idx (K or K/2, N) · codebook (G, B) → (M/pool², N)``.

    ``bias (N,)`` and ``relu`` are the fused epilogue; ``pool > 1`` expects
    window-major rows (``M % pool² == 0``) and stores the pooled map.  ``x``
    is f32, bf16 or f16; :func:`k1_plan` picks the kernel.  The output is
    f32.  ``whole = (M, N)`` of the unsharded call when this launch computes
    one rank's block of it (:func:`k1_plan`).
    """
    if x.ndim != 2:
        raise ValueError(f"x must be 2-D (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    N = idx.shape[-1]
    pw = pool * pool
    if M % pw:
        raise ValueError(f"pool={pool} needs window-major rows, M={M} % {pw}")
    plan = k1_plan(M, K, N, x.dtype, pool, packed=packed,
                   groups=codebook.shape[0] if codebook.ndim else 1, whole=whole)
    simt = plan.route == "simt"
    if simt:
        x, codebook = _widen(x, codebook)
    _check_operands(x, idx, codebook, bias, packed=packed, gather=gather,
                    k_rows=K, x_dtype=torch.float32 if simt else torch.bfloat16)
    G, B = codebook.shape
    if x.device.type == "cpu":
        return pasm_matmul_plain(x, idx, codebook, bias, packed=packed,
                                 relu=relu, pool=pool)
    if x.device.type != "cuda":
        raise ValueError(f"no PASM kernel for device {x.device}")
    out = torch.empty((M // pw, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    from repro_torch.kernels import _build

    part = torch.empty(plan.scratch, dtype=torch.float32,
                       device=x.device) if plan.scratch else None
    with _on(x.device):
        if simt:
            fn = _build.entry_point("pasm_matmul", "pasm_matmul_launch",
                                    [_P] * 6 + [_L] + [_I] * 10 + [_P])
            err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                     _ptr(part), M, K, N, G, B, int(packed), int(relu), pool,
                     plan.tile, plan.cols, plan.splits, _stream(x.device))
        else:
            fn = _build.entry_point("pasm_matmul_bf16", "pasm_matmul_bf16_launch",
                                    [_P] * 6 + [_I] * 10 + [_P])
            err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                     _ptr(part), M, K, N, G, B, int(packed), int(relu),
                     int(plan.route == "mma"), plan.splits, plan.tile,
                     _stream(x.device))
    _raise_on(err, f"pasm_matmul ({plan.route})")
    launches["pasm_matmul"] += 1
    k1_routes[plan.route] += 1
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
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """K2: implicit-GEMM conv, ``x (B, C, H, W)`` or ``(B, H, W, C)`` →
    ``(B, P_out, N)`` f32, any batch: the rows run over the batch, and the
    tile and split-K are :func:`simt_plan`'s over its ``B · P_rows`` rows
    (``whole``: the unsharded call's, as in K1).  A bf16 or f16 ``x`` runs
    on its exact f32 widening, the codebook rounded to its dtype
    (:func:`_widen`), K1's f32 route.

    ``x`` is the UNPADDED image batch: ``geom.pad`` is applied as masked
    zero reads inside the kernel (the TPU kernel took a padded image).
    ``idx`` holds ``Kp >= geom.conv_k`` reduction rows; positions past
    ``conv_k`` (the §3 pack-time pad) pair with zero activations.
    """
    Kp = idx.shape[0] * (2 if packed else 1) if idx.ndim == 2 else -1
    x, codebook = _widen(x, codebook)
    _check_operands(x, idx, codebook, bias, packed=packed, gather=gather,
                    k_rows=Kp)
    batch = x.shape[0]
    C, H, W = _check_image(x, geom, Kp)
    N = idx.shape[1]
    plan = simt_plan(batch * geom.P_rows, Kp, N, geom.pool, whole=whole)
    if x.device.type == "cpu":
        return pasm_conv_plain(x, idx, codebook, bias, geom=geom,
                               packed=packed, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"no PASM kernel for device {x.device}")
    out = torch.empty((batch, geom.P_out, N), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import _build

    part = torch.empty(plan.scratch, dtype=torch.float32,
                       device=x.device) if plan.scratch else None
    fn = _build.entry_point("pasm_conv", "pasm_conv_launch",
                            [_P] * 6 + [_L] + [_I] * 22 + [_P])
    G, B = codebook.shape
    (plh, _), (plw, _) = geom.pad
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(idx), _ptr(codebook), _ptr(bias), _ptr(out),
                 _ptr(part), batch, C, H, W, int(geom.nhwc), geom.ky, geom.kx,
                 geom.stride, plh, plw, geom.ow, geom.pool, geom.P_out,
                 geom.conv_k, Kp, N, G, B, int(packed), int(relu), plan.tile,
                 plan.cols, plan.splits, _stream(x.device))
    _raise_on(err, "pasm_conv")
    launches["pasm_conv"] += 1
    return out
