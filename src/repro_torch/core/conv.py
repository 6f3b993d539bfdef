"""Weight-shared convolution — the `ConvParams`/`conv2d` surface.

Port of ``repro.core.conv``.  Two types and one entry point:

* :class:`ConvParams` — tagged conv weights: ``dense``, weight-``shared``
  (uint8 bin indices + codebook) or int4-``packed`` (§3 K-pad applied
  before packing so odd ``C·KY·KX`` reductions pack);
* :class:`Conv2D` — the geometry-free layer spec (kernel, channels, stride,
  ``padding="valid_centred"|"valid"|"same"``, ``layout="NCHW"|"NHWC"``,
  bias gate, ReLU);
* :func:`conv2d` — dispatches (params kind × engine):

  ===================  =======================================================
  engine               meaning
  ===================  =======================================================
  ``auto``             dense → einsum; shared/packed → ``kernel_implicit``
                       when batched, einsum for single images
  ``einsum``           plain reference: (dequantized) dense GEMM + epilogue
  ``kernel``           K1 (:func:`repro_torch.kernels.ops.pasm_matmul`) over
                       an explicit im2col patch matrix
  ``kernel_implicit``  K2 (:func:`repro_torch.kernels.ops.pasm_conv2d`):
                       patch tiles gathered inside the kernel
  ``pas_kernel``       K3 (:func:`repro_torch.kernels.ops.pas_matmul`): the
                       paper-faithful two-phase PAS GEMM over the patches
  ``pas_kernel_``      K4 (:func:`repro_torch.kernels.ops.pas_conv2d`): K3's
  ``implicit``         PAS phase on in-kernel patch tiles
  ``pas_einsum``       plain two-phase reference: one-hot histogram, then
                       the post-pass multiply
  ===================  =======================================================

  The three PAS engines take one dictionary per layer.  ``mesh=`` runs the
  layer sharded (:func:`conv2d`), bitwise the single-device call;
  :func:`conv2d_shard` is its per-rank body.

Convolution lowers onto the GEMM via im2col in the layout's column order —
NCHW in the paper's ``(c, ky, kx)`` order, NHWC channels-minor
``(ky, kx, c)`` — and the weight container flattens itself into the matching
``(K, c_out)`` operand.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import pasm as _pasm
from repro_torch.core._f32 import matmul_f32
from repro_torch.core.params import PasmParams

__all__ = [
    "Conv2D",
    "ConvParams",
    "conv2d",
    "conv2d_shard",
    "shard_batch",
    "gather_batch",
    "conv_out_hw",
    "conv_geom",
    "conv_plan",
    "max_pool2d",
    "quantize_conv_weights",
    "PADDINGS",
    "LAYOUTS",
    "POOL_IMPLS",
]

PADDINGS = ("valid_centred", "valid", "same")
LAYOUTS = ("NCHW", "NHWC")
ENGINES = (
    "auto",
    "einsum",
    "kernel",
    "kernel_implicit",
    "pas_kernel",
    "pas_kernel_implicit",
    "pas_einsum",
)
_PAS_ENGINES = ("pas_kernel", "pas_kernel_implicit", "pas_einsum")
POOL_IMPLS = ("auto", "fused", "unfused")

# GEMM column order per layout: NCHW flattens patches (and weights) in the
# paper's (c, ky, kx) loop-nest order; NHWC is channels-minor (ky, kx, c).
_ORDER = {"NCHW": "ckk", "NHWC": "kkc"}


# ---------------------------------------------------------------------------
# the layer spec
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Conv2D:
    """Geometry-free conv layer spec (image H/W are read off the input)."""

    k: Union[int, tuple]
    c_in: int
    c_out: int
    stride: int = 1
    padding: str = "valid_centred"
    layout: str = "NCHW"
    bias: bool = True  # apply ``params.bias`` when present
    relu: bool = False

    def __post_init__(self):
        k = (self.k, self.k) if isinstance(self.k, int) else tuple(self.k)
        object.__setattr__(self, "k", k)
        if self.padding not in PADDINGS:
            raise ValueError(f"padding must be one of {PADDINGS}, got {self.padding!r}")
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {self.layout!r}")

    @property
    def ky(self) -> int:
        return self.k[0]

    @property
    def kx(self) -> int:
        return self.k[1]

    @property
    def K(self) -> int:
        """The im2col reduction length ``c_in·ky·kx``."""
        return self.c_in * self.ky * self.kx


def _axis_geometry(size: int, k: int, stride: int, padding: str) -> tuple:
    """One spatial axis → ``(out, pad_lo, pad_hi)``.

    ``same`` matches XLA/TF SAME (out = ceil(size/stride), asymmetric zero
    pad); ``valid`` is standard VALID; ``valid_centred`` is the paper's
    kernel-centred loop bounds — identical to ``valid`` for odd kernels, one
    output short when an even kernel tiles the axis exactly.
    """
    if padding == "same":
        out = -(-size // stride)
        pad = max((out - 1) * stride + k - size, 0)
        return out, pad // 2, pad - pad // 2
    if padding == "valid":
        return (size - k) // stride + 1, 0, 0
    return (size - 2 * (k // 2) + stride - 1) // stride, 0, 0


def conv_out_hw(ih: int, iw: int, conv: Conv2D) -> tuple:
    """Output (OH, OW) of ``conv`` on an ``ih × iw`` image."""
    oh, _, _ = _axis_geometry(ih, conv.ky, conv.stride, conv.padding)
    ow, _, _ = _axis_geometry(iw, conv.kx, conv.stride, conv.padding)
    return oh, ow


def conv_geom(conv: Conv2D, ih: int, iw: int, pool: int = 1):
    """Resolve the spec against an ``ih × iw`` image into the
    :class:`repro_torch.kernels.pasm_matmul.ConvGeom` K2 takes."""
    from repro_torch.kernels.pasm_matmul import ConvGeom

    oh, plo_h, phi_h = _axis_geometry(ih, conv.ky, conv.stride, conv.padding)
    ow, plo_w, phi_w = _axis_geometry(iw, conv.kx, conv.stride, conv.padding)
    return ConvGeom(nhwc=conv.layout == "NHWC", ky=conv.ky, kx=conv.kx,
                    stride=conv.stride, oh=oh, ow=ow, c_in=conv.c_in,
                    pad=((plo_h, phi_h), (plo_w, phi_w)), pool=pool)


# ---------------------------------------------------------------------------
# the weight container
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvParams:
    """Tagged conv weights: ``dense`` | weight-``shared`` | int4-``packed``.

    ``dense``   ``kernel (c_out, c_in, ky, kx)``; ``idx``/``codebook`` None.
    ``shared``  ``idx (c_out, c_in, ky, kx) uint8`` + ``codebook (bins,)``
                (one dictionary per layer) or ``(groups, bins)`` with one
                dictionary per segment of the GEMM reduction axis (``order``
                records which layout's flatten order the groups split).
    ``packed``  ``idx (Kp//2, c_out) uint8`` in the GEMM ``(K, M)`` layout of
                ``order``; ``pad_k`` rows were appended by the §3 K-pad.
    ``bias``    ``(c_out,)`` or None on every kind — never shared (paper §4).
    """

    kernel: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None
    codebook: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    kind: str = "dense"
    kshape: tuple = ()
    bins: Optional[int] = None
    order: Optional[str] = None
    pad_k: int = 0

    # -- constructors -------------------------------------------------------

    @classmethod
    def dense(cls, kernel: torch.Tensor, *, bias: Optional[torch.Tensor] = None):
        """Non-weight-shared params from a ``(c_out, c_in, ky, kx)`` kernel."""
        if kernel.ndim != 4:
            raise ValueError(
                f"kernel must be (c_out, c_in, ky, kx), got {tuple(kernel.shape)}")
        return cls(kernel=kernel, bias=bias, kind="dense",
                   kshape=tuple(kernel.shape))

    @classmethod
    def shared(cls, idx: torch.Tensor, codebook: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None, order: Optional[str] = None):
        """Weight-shared params from existing bin indices + dictionary.

        A 1-D ``codebook (bins,)`` is the one-dictionary-per-layer rule; a
        2-D ``(groups, bins)`` needs ``order`` (``"ckk"``/``"kkc"``): group
        membership is a function of the flat K position.
        """
        if idx.ndim != 4:
            raise ValueError(f"idx must be (c_out, c_in, ky, kx), got {tuple(idx.shape)}")
        if codebook.ndim == 2 and codebook.shape[0] == 1:
            codebook = codebook.reshape(-1)  # (1, B) ≡ the single-dict rule
        groups = 1 if codebook.ndim == 1 else int(codebook.shape[0])
        if groups > 1 and order not in _ORDER.values():
            raise ValueError(
                "grouped codebooks split the flattened reduction axis: pass "
                f"order='ckk'|'kkc' (the layout they were built for), got {order!r}"
            )
        if int(idx[0].numel()) % groups:
            raise ValueError(
                f"K = c_in·ky·kx = {idx[0].numel()} not divisible by groups={groups}")
        return cls(idx=idx.to(torch.uint8), codebook=codebook, bias=bias,
                   kind="shared", kshape=tuple(idx.shape),
                   bins=int(codebook.shape[-1]),
                   order=order if groups > 1 else None)

    @classmethod
    def quantize(cls, kernel: torch.Tensor, bins: int = 16, *,
                 bias: Optional[torch.Tensor] = None, iters: int = 16,
                 groups: int = 1, layout: str = "NCHW"):
        """K-means weight-share a dense kernel (``groups=1``: the paper's one
        dictionary per layer; ``groups > 1`` splits the GEMM reduction axis
        flattened in ``layout``'s order and pins the params to it)."""
        if groups == 1:
            cb, idx = quantize_conv_weights(kernel, bins, iters=iters)
            return cls.shared(idx, cb, bias=bias)
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        K = int(kernel[0].numel())
        if K % groups:
            raise ValueError(f"K = c_in·ky·kx = {K} not divisible by groups={groups}")
        order = _ORDER[layout]
        p = PasmParams.quantize(_flatten_kernel(kernel, order), bins,
                                groups=groups, iters=iters)
        return cls.shared(_unflatten_kernel(p.idx, order, tuple(kernel.shape)),
                          p.codebook, bias=bias, order=order)

    def pack(self, *, layout: str = "NCHW") -> "ConvParams":
        """int4-pack the dictionary indices into the GEMM layout of ``layout``
        (odd ``C·KY·KX`` gets the §3 reserved-zero-bin K-pad first)."""
        if self.kind != "shared":
            raise ValueError(
                f"pack() needs shared params (got {self.kind!r}); "
                "quantize() dense kernels first"
            )
        if layout not in LAYOUTS:
            raise ValueError(f"layout must be one of {LAYOUTS}, got {layout!r}")
        order = _ORDER[layout]
        self._check_order(order)
        base = PasmParams.shared(_flatten_kernel(self.idx, order),
                                 self.codebook).pack()
        return ConvParams(
            idx=base.idx,
            codebook=(base.codebook.reshape(-1) if self.codebook.ndim == 1
                      else base.codebook),
            bias=self.bias, kind="packed", kshape=self.kshape, bins=base.bins,
            order=order, pad_k=base.pad_k,
        )

    # -- views --------------------------------------------------------------

    @property
    def c_out(self) -> int:
        return self.kshape[0]

    @property
    def groups(self) -> int:
        """Codebook groups along the GEMM reduction axis (1 = paper rule)."""
        cb = self.codebook
        return 1 if cb is None or cb.ndim == 1 else int(cb.shape[0])

    def _grouped_codebook(self) -> torch.Tensor:
        """The ``(G, B)`` f32 codebook the kernels consume."""
        cb = self.codebook.to(torch.float32)
        return cb.reshape(1, -1) if cb.ndim == 1 else cb

    def _check_order(self, order: str) -> None:
        if self.order is not None and order != self.order:
            what = "packed" if self.kind == "packed" else "grouped"
            fix = "re-pack" if self.kind == "packed" else "re-quantize"
            raise ValueError(
                f"params were {what} for order {self.order!r} but this layout "
                f"needs {order!r}; {fix} for this layout"
            )

    def _as_pasm(self, order: str) -> PasmParams:
        """The geometry-free container view, idx flattened into ``order``."""
        if self.kind == "packed":
            return PasmParams(
                idx=self.idx, codebook=self._grouped_codebook(), bias=self.bias,
                kind="packed",
                shape=(self.idx.shape[0] * 2 - self.pad_k, self.c_out),
                bins=self.bins, pad_k=self.pad_k,
            )
        if self.kind == "shared":
            return PasmParams(
                idx=_flatten_kernel(self.idx, order),
                codebook=self._grouped_codebook(), bias=self.bias,
                kind="shared", shape=(int(self.idx[0].numel()), self.c_out),
                bins=self.bins,
            )
        return PasmParams.dense(_flatten_kernel(self.kernel, order), bias=self.bias)

    def gemm_tensor(self, layout: str = "NCHW") -> _pasm.PASMTensor:
        """The dictionary as the ``(K, M)`` GEMM operand for ``layout``."""
        order = _ORDER[layout]
        if self.kind == "dense":
            raise ValueError("dense params have no dictionary; use engine='einsum'")
        self._check_order(order)
        return self._as_pasm(order).gemm_tensor()

    def dense_operand(self, layout: str = "NCHW") -> torch.Tensor:
        """The ``(K(+pad_k), M)`` dense GEMM operand (einsum reference path).

        Dtype is preserved for dense/shared kinds; packed dequantizes to f32.
        """
        if self.kind == "dense":
            return _flatten_kernel(self.kernel, _ORDER[layout])
        if self.kind == "shared":
            if self.groups == 1:
                kernel = self.codebook[self.idx.long()]
                return _flatten_kernel(kernel, _ORDER[layout])
            self._check_order(_ORDER[layout])
            idxf = _flatten_kernel(self.idx, _ORDER[layout])
            return _pasm.codebook_lookup(self.codebook, idxf)
        return _pasm.dequantize(self.gemm_tensor(layout))


def _flatten_kernel(a: torch.Tensor, order: str) -> torch.Tensor:
    """(c_out, c_in, ky, kx) → (K, c_out) flat in ``order`` ∈ {ckk, kkc}."""
    if order == "kkc":
        a = a.permute(0, 2, 3, 1)  # (c_out, ky, kx, c_in)
    return a.reshape(a.shape[0], -1).T


def _unflatten_kernel(flat: torch.Tensor, order: str, kshape: tuple) -> torch.Tensor:
    """Inverse of :func:`_flatten_kernel`: (K, c_out) → (c_out, c_in, ky, kx)."""
    c_out, c_in, ky, kx = kshape
    a = flat.T
    if order == "kkc":
        return a.reshape(c_out, ky, kx, c_in).permute(0, 3, 1, 2)
    return a.reshape(kshape)


# ---------------------------------------------------------------------------
# im2col (both layouts, all paddings)
# ---------------------------------------------------------------------------


def _batched4(x: torch.Tensor) -> tuple:
    if x.ndim == 3:
        return x[None], True
    if x.ndim == 4:
        return x, False
    raise ValueError(
        f"x must be a single image (3-D) or a batch (4-D), got {tuple(x.shape)}")


def _im2col(xb: torch.Tensor, conv: Conv2D) -> tuple:
    """Batched patches in the layout's GEMM column order; returns
    ``(patches (B·P, K), (oh, ow))``."""
    from repro_torch.kernels.ref import im2col_patches

    nhwc = conv.layout == "NHWC"
    ih, iw = (xb.shape[1], xb.shape[2]) if nhwc else (xb.shape[2], xb.shape[3])
    oh, plo_h, phi_h = _axis_geometry(ih, conv.ky, conv.stride, conv.padding)
    ow, plo_w, phi_w = _axis_geometry(iw, conv.kx, conv.stride, conv.padding)
    patches = im2col_patches(
        xb, nhwc=nhwc, ky=conv.ky, kx=conv.kx, stride=conv.stride,
        oh=oh, ow=ow, c_in=conv.c_in, pad=((plo_h, phi_h), (plo_w, phi_w)),
    )
    return patches, (oh, ow)


def _col2im(y: torch.Tensor, conv: Conv2D, batch: int, oh: int, ow: int,
            squeeze: bool) -> torch.Tensor:
    """GEMM output (B·P, M) → feature map in the spec's layout."""
    if conv.layout == "NHWC":
        out = y.reshape(batch, oh, ow, conv.c_out)
    else:
        out = y.reshape(batch, oh * ow, conv.c_out)
        out = out.movedim(-1, 1).reshape(batch, conv.c_out, oh, ow)
    return out[0] if squeeze else out


def max_pool2d(x: torch.Tensor, pool: int, layout: str) -> torch.Tensor:
    """Non-overlapping max pool, VALID (floor) windowing, layout-aware.

    The unfused reference (and fallback path) of ``conv2d(pool=)``; takes a
    batched 4-D feature map or a single 3-D one.  The window init is the
    dtype's max identity — ``iinfo(dtype).min`` for integer maps, ``-inf``
    for floats — and every window is fully covered, so the init never leaks
    into the output.
    """
    if pool == 1:
        return x
    if x.ndim not in (3, 4):
        raise ValueError(f"max_pool2d needs a 3-D or 4-D feature map, got {tuple(x.shape)}")
    nhwc = layout == "NHWC"
    h_ax = x.ndim - 3 if nhwc else x.ndim - 2
    oh, ow = x.shape[h_ax] // pool, x.shape[h_ax + 1] // pool
    if x.dtype.is_floating_point:
        init = float("-inf")
    else:
        init = torch.iinfo(x.dtype).min
    shape = list(x.shape)
    shape[h_ax], shape[h_ax + 1] = oh, ow
    out = torch.full(shape, init, dtype=x.dtype, device=x.device)
    if oh == 0 or ow == 0:  # an axis shorter than the window: no window
        return out
    for dy in range(pool):
        for dx in range(pool):
            win = x.narrow(h_ax, dy, (oh - 1) * pool + 1)
            win = win.narrow(h_ax + 1, dx, (ow - 1) * pool + 1)
            sl = [slice(None)] * x.ndim
            sl[h_ax] = slice(None, None, pool)
            sl[h_ax + 1] = slice(None, None, pool)
            out = torch.maximum(out, win[tuple(sl)])
    return out


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


def _resolve_engine(engine: str, params: ConvParams, squeeze: bool,
                    conv: Conv2D, ih: int, iw: int) -> str:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    if params.kind == "dense":
        if engine in ("auto", "einsum"):
            return "einsum"
        raise ValueError(f"dense params have no dictionary; engine {engine!r} "
                         "needs shared/packed params")
    if params.groups > 1 and engine in _PAS_ENGINES:
        raise ValueError(
            "the PAS formulation is paper-faithful single-dictionary; grouped "
            "codebooks need engine='kernel'/'kernel_implicit'/'einsum'"
        )
    if engine == "auto":
        # batched inputs ride the implicit-GEMM kernel; single images keep the
        # einsum reference; degenerate geometry (no output pixels) keeps the
        # explicit path, whose empty patch matrix handles it
        if squeeze:
            return "einsum"
        oh, ow = conv_out_hw(ih, iw, conv)
        return "kernel_implicit" if oh > 0 and ow > 0 else "kernel"
    return engine


def _pool_fusible(eng: str, conv: Conv2D, ih: int, iw: int, pool: int) -> bool:
    """``conv2d(pool=)``'s ``auto`` fuse predicate: a kernel engine, at least
    one whole window per axis, and a pool-aligned tile plan."""
    if pool == 1 or eng in ("einsum", "pas_einsum"):
        return False
    oh, ow = conv_out_hw(ih, iw, conv)
    if oh < pool or ow < pool:
        return False
    from repro_torch.kernels.ops import pool_plan_exists

    return pool_plan_exists(pool)


def conv_plan(params: ConvParams, conv: Conv2D, ih: int, iw: int, *,
              engine: str = "auto", pool: int = 1, pool_impl: str = "auto",
              vmem_budget: Optional[int] = None, mesh=None,
              batched: bool = True) -> tuple:
    """The ``(engine, fused_pool)`` pair :func:`conv2d` would dispatch.

    ``vmem_budget`` is kept for signature parity with the JAX package; the
    port has no VMEM schedule, so it never changes the plan.  Neither does
    ``mesh``: every engine fuses the pool under a mesh, as on one device
    (``conv2d`` pads the batch so window-major rows split in whole windows).
    """
    del vmem_budget, mesh
    eng = _resolve_engine(engine, params, not batched, conv, ih, iw)
    fused = (pool > 1 and pool_impl != "unfused"
             and _pool_fusible(eng, conv, ih, iw, pool))
    return eng, fused


def _pool_order_patches(patches: torch.Tensor, batch: int, oh: int, ow: int,
                        pool: int) -> torch.Tensor:
    """Row-major ``(B·P, K)`` patches → window-major ``(B·P_out·pool², K)``;
    floor-remainder pixels are dropped — the rows K2 walks."""
    K = patches.shape[1]
    ohp, owp = oh // pool, ow // pool
    pm = patches.reshape(batch, oh, ow, K)[:, : ohp * pool, : owp * pool]
    pm = pm.reshape(batch, ohp, pool, owp, pool, K).permute(0, 1, 3, 2, 4, 5)
    return pm.reshape(batch * ohp * owp * pool * pool, K)


def _dispatch(x: torch.Tensor, params: ConvParams, conv: Conv2D, engine: str,
              pool, pool_impl: str, mesh) -> tuple:
    """:func:`conv2d`'s checks and plan: ``(xb, squeeze, engine, fused_pool,
    pool)``, ``xb`` the batched input."""
    if pool_impl not in POOL_IMPLS:
        raise ValueError(f"pool_impl must be one of {POOL_IMPLS}, got {pool_impl!r}")
    if int(pool) != pool or pool < 1:
        raise ValueError(f"pool must be a positive integer window, got {pool!r}")
    pool = int(pool)
    xb, squeeze = _batched4(x)
    nhwc = conv.layout == "NHWC"
    c_axis = -1 if nhwc else 1
    if xb.shape[c_axis] != conv.c_in:
        raise ValueError(
            f"input {tuple(x.shape)} has {xb.shape[c_axis]} channels on the "
            f"{conv.layout} channel axis; spec says c_in={conv.c_in}"
        )
    if params.kshape != (conv.c_out, conv.c_in, conv.ky, conv.kx):
        raise ValueError(
            f"params kshape {params.kshape} does not match spec "
            f"{(conv.c_out, conv.c_in, conv.ky, conv.kx)}"
        )
    ih, iw = (xb.shape[1], xb.shape[2]) if nhwc else (xb.shape[2], xb.shape[3])
    eng, fuse_pool = conv_plan(
        params, conv, ih, iw, engine=engine, pool=pool, pool_impl=pool_impl,
        mesh=mesh, batched=not squeeze,
    )
    if pool_impl == "fused" and pool > 1 and not fuse_pool:
        raise ValueError(
            f"pool_impl='fused' but engine {eng!r} cannot fuse pool={pool} "
            "here (einsum, sub-window outputs and oversize windows all need "
            "the max_pool2d fallback — pool_impl='auto' picks it automatically)"
        )
    if mesh is not None:
        if squeeze:
            raise ValueError(
                "mesh= shards the batch over the 'data' axis; pass a batched "
                "4-D input"
            )
        if eng == "pas_einsum":
            raise ValueError(
                "pas_einsum is the single-device reference port; mesh= runs "
                "on einsum or the kernel engines"
            )
    return xb, squeeze, eng, fuse_pool, pool


def conv2d(
    x: torch.Tensor,
    params: ConvParams,
    conv: Conv2D,
    *,
    engine: str = "auto",
    mesh=None,
    vmem_budget: Optional[int] = None,
    pool: int = 1,
    pool_impl: str = "auto",
) -> torch.Tensor:
    """The conv entry point: any params kind, a ported engine, any layout.

    ``x`` is a single image or a batch in ``conv.layout`` order.  On the
    kernel engines the bias/ReLU epilogue is fused into the kernel, so a
    batched conv layer is one launch — on ``kernel_implicit`` a launch over
    the raw image.  ``pool > 1`` appends a non-overlapping ``(pool, pool)``
    max-pool (floor windowing); ``pool_impl="auto"`` fuses it into the
    kernel epilogue where possible, ``"fused"`` demands that, ``"unfused"``
    runs :func:`max_pool2d` after.  ``vmem_budget`` is kept for signature
    parity and unused by the port.

    ``mesh=`` (a ``("data", "model")``
    :class:`~repro_torch.launch.mesh.Mesh`; every rank calls with the same
    global ``x``) runs the layer sharded: the batch over ``data`` (an
    uneven remainder is zero-padded in and sliced off), the output channels
    over ``model`` when they divide it.  ``params`` are the global weights
    or this rank's ``model`` block (``cnn.quantize(mesh=)``).  Every rank
    returns the global output, bitwise the single-device call's on every
    engine but ``pas_einsum``, which refuses a mesh.
    """
    del vmem_budget
    xb, squeeze, eng, fuse_pool, pool = _dispatch(x, params, conv, engine,
                                                  pool, pool_impl, mesh)
    if mesh is None:
        return _conv2d(xb, params, conv, eng, fuse_pool, pool, squeeze)
    y = _conv2d(shard_batch(xb, mesh), params, conv, eng, fuse_pool, pool,
                False, mesh)
    return gather_batch(y, mesh, xb.shape[0])


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``data`` block of a global image batch, an uneven
    remainder zero-padded in first (the sharded stack's input).  The batch
    is replicated over ``data``: it enters the rank's rows through
    ``enter_split``, so a batch that needs a gradient gets it whole."""
    from repro_torch.launch.mesh import data_model_sizes, enter_split
    from repro_torch.models.sharding import (
        conv_batch_pad, conv_input_pspecs, local_shard)

    if x.ndim != 4:
        raise ValueError("mesh= shards the batch over the 'data' axis; pass a "
                         "batched 4-D input")
    pad_b = conv_batch_pad(x.shape[0], data_model_sizes(mesh)[0])
    if pad_b:
        x = F.pad(x, (0, 0) * 3 + (0, pad_b))
    return local_shard(enter_split(x, mesh, "data"), conv_input_pspecs(), mesh)


def gather_batch(y: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """Every rank's ``data`` block of an output gathered, the pad images of
    :func:`shard_batch` sliced off: the global result on every rank
    (differentiable: a rank's block gets its rows of the gradient)."""
    from repro_torch.launch.mesh import all_gather
    from repro_torch.models.sharding import DATA

    return all_gather(y, mesh, DATA, dim=0)[:batch]


def conv2d_shard(
    x: torch.Tensor,
    params: ConvParams,
    conv: Conv2D,
    *,
    mesh,
    engine: str = "auto",
    pool: int = 1,
    pool_impl: str = "auto",
) -> torch.Tensor:
    """One rank's part of :func:`conv2d` under ``mesh``: ``x`` is this
    rank's ``data`` block of the batch, and so is the result (every output
    channel: the ``model`` blocks are gathered).  ``models/cnn.py::forward``
    runs its stages through this, so activations stay ``data``-local from
    layer to layer and the batch is gathered once, at the head.
    Differentiable on every engine (``kernels/ops.py::shard_gemm``)."""
    xb, _, eng, fuse_pool, pool = _dispatch(x, params, conv, engine, pool,
                                            pool_impl, mesh)
    return _conv2d(xb, params, conv, eng, fuse_pool, pool, False, mesh)


def _einsum_sharded(patches: torch.Tensor, w: torch.Tensor, bias, relu: bool,
                    mesh, n_cols: int) -> torch.Tensor:
    """The plain reference engine under a mesh (the dense-params path):
    this rank's rows, N over ``model`` when it divides — the kernel
    engines' axis mapping, through the same dispatch."""
    from repro_torch.kernels.ops import shard_gemm
    from repro_torch.kernels.ref import apply_epilogue

    return shard_gemm(
        mesh, n_cols,
        lambda pt, wl, _cb, bl, _whole: apply_epilogue(matmul_f32(pt, wl), bl, relu),
        patches, w, None, bias, local_rows=True)


def _conv2d(xb: torch.Tensor, params: ConvParams, conv: Conv2D, eng: str,
            fuse_pool: bool, pool: int, squeeze: bool, mesh=None) -> torch.Tensor:
    """The dispatched layer on a batch: under ``mesh``, this rank's rows."""
    bias = params.bias if conv.bias else None
    batch = xb.shape[0]
    nhwc = conv.layout == "NHWC"
    ih, iw = (xb.shape[1], xb.shape[2]) if nhwc else (xb.shape[2], xb.shape[3])
    shard = dict(mesh=mesh, local_rows=True)

    if eng in ("kernel_implicit", "pas_kernel_implicit"):
        from repro_torch.kernels import ops as _kops

        geom = conv_geom(conv, ih, iw, pool=pool if fuse_pool else 1)
        f = _kops.pasm_conv2d if eng == "kernel_implicit" else _kops.pas_conv2d
        y = f(xb, params.gemm_tensor(conv.layout), geom, bias=bias,
              relu=conv.relu, **shard)
        y = y.reshape(-1, conv.c_out)  # (B, P, M) → (B·P, M)
        if fuse_pool:
            return _col2im(y, conv, batch, geom.ohp, geom.owp, squeeze)
        out = _col2im(y, conv, batch, geom.oh, geom.ow, squeeze)
        return max_pool2d(out, pool, conv.layout)

    patches, (oh, ow) = _im2col(xb, conv)
    if fuse_pool:
        patches = _pool_order_patches(patches, batch, oh, ow, pool)
    if params.pad_k:  # §3 pack-time K-pad rows pair with zero activations
        patches = F.pad(patches, (0, params.pad_k))
    if eng == "einsum":
        from repro_torch.kernels.ref import apply_epilogue

        # the product in the promoted dtype, as jnp's ``patches @ w``: bf16
        # images against an f32 dictionary multiply in f32
        w = params.dense_operand(conv.layout)
        dt = torch.promote_types(patches.dtype, w.dtype)
        patches, w = patches.to(dt), w.to(dt)
        if mesh is not None:
            y = _einsum_sharded(patches, w, bias, conv.relu, mesh, conv.c_out)
        else:
            y = apply_epilogue(matmul_f32(patches, w), bias, conv.relu)
    elif eng == "pas_einsum":
        from repro_torch.kernels.ref import apply_epilogue

        y = apply_epilogue(_pas_einsum(patches, params, conv.layout), bias,
                           conv.relu)
    else:
        from repro_torch.kernels import ops as _kops

        f = _kops.pasm_matmul if eng == "kernel" else _kops.pas_matmul
        y = f(patches, params.gemm_tensor(conv.layout), bias=bias,
              relu=conv.relu, pool=pool if fuse_pool else 1, **shard)
    if fuse_pool:
        return _col2im(y, conv, batch, oh // pool, ow // pool, squeeze)
    out = _col2im(y, conv, batch, oh, ow, squeeze)
    return max_pool2d(out, pool, conv.layout)


def _pas_einsum(patches: torch.Tensor, params: ConvParams,
                layout: str) -> torch.Tensor:
    """The two-phase PASM formulation in plain torch (Fig 13).

    ``patches`` already carry the §3 ``pad_k`` zero columns.  Per output
    pixel and channel: PAS bins from a one-hot histogram over the patch
    axis, then one multiply per bin (:func:`~repro_torch.kernels.ref.
    pas_matmul_ref`) — bit-exact on integer inputs.  bf16 or f16 patches
    run both steps in their dtype, as the JAX reference's einsums do: the
    bins, the dictionary and the output rounded to it.
    """
    from repro_torch.kernels.ref import pas_matmul_ref

    if params.kind == "packed":
        idx = _pasm.logical_idx(params.gemm_tensor(layout))  # (K+pad, M)
    else:
        idx = _flatten_kernel(params.idx, _ORDER[layout])  # (K, M)
    cb = params.codebook.reshape(1, -1)
    if patches.dtype == torch.float32:
        return pas_matmul_ref(patches, idx, cb)
    return pas_matmul_ref(patches, idx, cb.to(patches.dtype)).to(patches.dtype)


# ---------------------------------------------------------------------------
# the paper's one-dictionary quantizer on raw kernels
# ---------------------------------------------------------------------------


def quantize_conv_weights(kernel: torch.Tensor, bins: int, *,
                          iters: int = 16) -> tuple:
    """K-means weight-share a conv kernel: one dictionary per layer (paper §4).

    Returns ``(codebook (B,), bin_idx (M, C, KY, KX) uint8)``; the
    clustering is :meth:`PasmParams.quantize` over the kernel flattened to a
    single column, so conv and dense layers share one quantizer.
    """
    p = PasmParams.quantize(kernel.reshape(-1, 1), bins, iters=iters)
    return p.codebook[0], p.idx.reshape(kernel.shape).to(torch.uint8)
