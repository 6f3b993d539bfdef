"""Op wrappers around the Hopper kernels: shapes, layouts and the tile plan.

Port of ``repro.kernels.ops``: :func:`pasm_matmul` (K1) and
:func:`pasm_conv2d` (K2), and the paper-faithful two-phase
:func:`pas_matmul` (K3) and :func:`pas_conv2d` (K4), each with the fused
``bias`` / ``relu`` epilogue and the window-major ``pool``; and
:func:`flash_attention` (K5).

The PASM pair is differentiable in ``x``, the codebook and ``bias``, as the
JAX package's custom VJPs make it: when any of them requires grad the call
runs through :class:`_PasmMatmul` or :class:`_PasmConv`, a
``torch.autograd.Function`` whose forward is the kernel and whose backward
is the JAX package's, in plain torch (dx through the dequantized weight,
the codebook gradient the per-group bin sums of ``xᵀg``, the pooled
backward routed through a recomputed pre-pool map, the conv's dx through
im2colᵀ).  Each Function covers the JAX pair ``_pasm_matmul`` /
``_pasm_matmul_ep`` (and ``_pasm_conv`` / ``_pasm_conv_ep``): ``bias`` may
be None.  The kernel wrappers themselves stay forward-only and raise on
tensors that require grad.  The PAS pair is forward-only, as in the JAX
package; so is K5, which no model calls in training.

The TPU tile plan (``_pick_blocks``: 128/512 tiles, K padded to 128
multiples through a reserved zero-codebook bin) is replaced by the Hopper
plans the kernel wrappers derive from the shapes (``pasm_matmul.simt_plan``
for K1's f32 route and K2, ``pas_histogram.pas_plan`` for K3/K4): K1/K2's
block computes a 128-row tile (256 for pool windows of more than 128 rows)
by 64, 96 or 128 columns, a thread 8 rows × up to 8 columns, from a
``cp.async`` ring of 16-k stages, owns the whole pool windows that fit it,
and splits K by a count set by K and N alone, the partials added in order
by a second pass; K2 gathers its stages from the image through per-block
row and column tables, its rows running over the whole batch.  The kernels
mask the ragged M, N and K edges themselves, so no operand is padded in
memory.  The §3 pack-time ``pad_k`` row is data format, not tile plan, and
stays.

``SlabPlan`` / ``conv_slab_plan`` described a TPU VMEM schedule and are not
ported: K2 gathers from global memory, so any image size runs.

Every GEMM wrapper also takes ``mesh=``, a ``("data", "model")``
:class:`~repro_torch.launch.mesh.Mesh`: :func:`shard_gemm`, the JAX
package's ``shard_map`` dispatch run SPMD.  Rows (the batch) split over
``data`` and N over ``model`` when it divides; each rank launches the same
kernel on its block; codebooks are replicated and the bias follows N.
Every output sums in the single-device order: the kernels plan their
split-K from the whole call's shape (``whole=``), where the JAX kernels'
k-tile plan depended on K alone — so sharded outputs are bitwise the
single-device ones.  A sharded call takes global operands and returns the
global result on every rank; ``local_rows=True`` keeps the rows this
rank's (the per-layer call of ``core.conv.conv2d_shard``).  The LM's
tensor-parallel linears call K1/K3 on a rank's block directly with
``whole=`` (``core.params.block_matmul``): an N block needs no gather and
a K block's f32 partial is all-reduced over ``model`` by the caller.  The
sharded path trains: the collectives carry gradients
(``launch/mesh.py``), a replicated operand entering a rank's block passes
``enter_split``, and the K1/K2 Functions run on a rank's block as on the
whole call, their codebook and bias gradients this rank's part, which the
train step sums (``models/sharding.py::grad_reduce_axes``).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.core import pasm as _pasm
from repro_torch.core._f32 import matmul_f32
from repro_torch.core.qat import bin_sums
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.pas_histogram import (
    pas_conv_kernel_call,
    pas_matmul_kernel_call,
    pas_plan,
)
from repro_torch.kernels.pasm_matmul import (
    ConvGeom,
    k1_plan,
    pasm_conv_kernel_call,
    pasm_matmul_kernel_call,
    pool_plan_exists,
    simt_plan,
)
from repro_torch.launch.mesh import all_gather, data_model_sizes, enter_split, n_shard_axis
from repro_torch.models.sharding import DATA, MODEL, P, local_shard

__all__ = ["pasm_matmul", "pas_matmul", "pasm_conv2d", "pas_conv2d",
           "flash_attention", "shard_gemm", "ConvGeom", "pool_plan_exists",
           "matmul_flops", "pasm_hbm_bytes", "conv_hbm_bytes"]


# ---------------------------------------------------------------------------
# the sharded dispatch
# ---------------------------------------------------------------------------


def _n_block(t: torch.Tensor, n_cols: int, mesh) -> torch.Tensor:
    """This rank's ``model`` block of an N-last operand: ``t`` is the global
    operand (N = ``n_cols``) or already the block (as ``cnn.quantize(mesh=)``
    places weights)."""
    nm = mesh.size(MODEL)
    if t.shape[-1] == n_cols:
        return local_shard(t, P(*([None] * (t.ndim - 1)), MODEL), mesh)
    if t.shape[-1] != n_cols // nm:
        raise ValueError(f"operand {tuple(t.shape)} is neither N = {n_cols} nor "
                         f"its {nm}-way model block")
    return t


def shard_gemm(mesh, n_cols: int, local_fn, x: torch.Tensor, w: torch.Tensor,
               codebook=None, bias=None, *, local_rows: bool = False,
               whole_lead: Optional[int] = None) -> torch.Tensor:
    """The one sharded dispatch every ``mesh=`` path routes through (the
    JAX package's ``shard_map`` ``_shard_gemm``), run SPMD on every rank.

    ``x``'s leading dim splits over ``data``: the global operand (its
    leading dim a multiple of the axis), or with ``local_rows`` already this
    rank's block.  ``w`` (N last) and ``bias`` split over ``model`` when
    :func:`~repro_torch.launch.mesh.n_shard_axis` says so, each the global
    operand or already this rank's block; ``codebook`` is replicated.
    ``local_fn(x, w, codebook, bias, whole)`` runs this rank's block with
    the single-device code (differentiable: ``x`` enters the rank's rows
    and N block through ``enter_split``, the gathers carry the gradient
    back; a weight's gradient is its block's or, given whole, zero outside
    the block, summed by the train step), ``whole = (leading dim, N)`` of the global call
    (``whole_lead`` overrides the leading dim: a padded call's true rows),
    which the kernels plan from.  The N blocks of the output are
    all-gathered over ``model`` in coordinate order (JAX's tiled
    ``all_gather``: the full-N output bitwise), then, unless ``local_rows``,
    the rows over ``data``, so every rank returns the global result.
    """
    nd, _ = data_model_sizes(mesh)
    ns = n_shard_axis(mesh, n_cols)
    if not local_rows:  # the replicated global rows: this rank's block
        x = local_shard(enter_split(x, mesh, DATA), P(DATA), mesh)
    if ns is not None:  # x is replicated over model, each rank's N block its own
        x = enter_split(x, mesh, MODEL)
        w = _n_block(w, n_cols, mesh)
        bias = None if bias is None else _n_block(bias, n_cols, mesh)
    elif w.shape[-1] != n_cols:
        raise ValueError(f"operand {tuple(w.shape)} is not N = {n_cols}, which "
                         "does not divide the model axis: pass it whole")
    whole = (x.shape[0] * nd if whole_lead is None else whole_lead, n_cols)
    y = local_fn(x, w, codebook, bias, whole)
    if ns is not None:
        y = all_gather(y, mesh, MODEL, dim=-1)
    return y if local_rows else all_gather(y, mesh, DATA, dim=0)


def _shard_rows(mesh, n_cols: int, local_fn, x2, w, codebook, bias, *,
                pool: int, local_rows: bool) -> torch.Tensor:
    """K1's and K3's ``mesh=`` rows: window-major pooled rows must split
    over ``data`` in whole pool windows (``conv2d`` pads the batch so they
    do); unpooled rows are padded up to the axis and sliced back."""
    nd, _ = data_model_sizes(mesh)
    M = x2.shape[0]
    if pool > 1:
        if not local_rows and M % (nd * pool * pool):
            raise ValueError(
                f"pool= under mesh= needs the window-major rows ({M}) to split "
                f"over the data axis ({nd}) in whole pool windows; "
                "conv2d(mesh=) guarantees this by padding the batch first")
        return shard_gemm(mesh, n_cols, local_fn, x2, w, codebook, bias,
                          local_rows=local_rows)
    pad = 0 if local_rows else -M % nd
    if pad:
        x2 = F.pad(x2, (0, 0, 0, pad))
    y = shard_gemm(mesh, n_cols, local_fn, x2, w, codebook, bias,
                   local_rows=local_rows, whole_lead=None if local_rows else M)
    return y[:M]


def _check_batch(x: torch.Tensor, mesh, local_rows: bool) -> None:
    nd, _ = data_model_sizes(mesh)
    if not local_rows and x.shape[0] % nd:
        raise ValueError(
            f"batch {x.shape[0]} does not divide the data axis ({nd}); "
            "pad the batch first (conv2d(mesh=) handles the remainder)")


def _pool_rows(x: torch.Tensor, pool: int) -> None:
    if x.ndim != 2 or x.shape[0] % (pool * pool):
        raise ValueError(
            "pool= needs a 2-D window-major x (pool² consecutive rows "
            f"per window), got shape {tuple(x.shape)} with pool={pool}"
        )


def _needs_grad(*ts) -> bool:
    """Whether a call must record a backward.  Serving calls the kernel
    directly: ``Function.apply`` alone costs about as much host time as a
    K1 launch's enqueue, which bounds a decode step."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                           for t in ts)


def _pasm_bwd(x, idx, codebook, packed: bool, g, need_dx: bool, need_dcb: bool):
    """The GEMM's backward: ``dx = g·Wᵀ`` in x's dtype, W dequantized to
    x's dtype; the codebook gradient the per-group bin sums of ``xᵀg`` in
    f32 (packed int4: lo nibble = even K row).  Either may be skipped."""
    dx = dcb = None
    if need_dx:
        w = _ref.dequant_ref(idx, codebook, packed=packed).to(x.dtype)
        dx = matmul_f32(g.to(x.dtype), w.T)
        del w
    if need_dcb:
        with trace.span("pasm.bwd_xg", device=x.is_cuda):
            xg = matmul_f32(x.T.float(), g.float())  # (K, N)
        with trace.span("pasm.bin_sums", device=x.is_cuda):
            li = _pasm.unpack_int4(idx) if packed else idx
            K, N = li.shape
            G, B = codebook.shape
            dcb = bin_sums(xg.reshape(G, K // G, N), li.reshape(G, K // G, N), B)
        dcb = dcb.to(codebook.dtype)
    return dx, dcb


def _pre_pool_bwd(y_lin, bias, relu: bool, pool_fn, g):
    """Route ``g`` through the pool argmax and the ReLU mask of the
    recomputed pre-pool map ``y_lin``: the fused forward never stores it.
    ``pool_fn``'s own backward (``amax``: ties share evenly, as
    ``jnp.max``'s VJP does) defines the routing.  Returns the cotangent at
    the linear output."""
    with torch.enable_grad():
        yl = y_lin.detach().requires_grad_()
        b = None if bias is None else bias.detach()
        out = pool_fn(_ref.apply_epilogue(yl, b, relu))
        g, = torch.autograd.grad(out, yl, g)
    return g


class _PasmMatmul(torch.autograd.Function):
    """``x @ dequant(idx, codebook)`` (+ ``bias``, ReLU, window-major pool)
    on K1, with the JAX package's ``_pasm_matmul`` / ``_pasm_matmul_ep``
    backward.  ``idx`` gets no gradient."""

    @staticmethod
    def forward(ctx, x, idx, codebook, bias, packed, gather, relu, pool, whole):
        y = pasm_matmul_kernel_call(x, idx, codebook, bias, packed=packed,
                                    relu=relu, pool=pool, gather=gather, whole=whole)
        ctx.packed, ctx.relu, ctx.pool = packed, relu, pool
        # y only for the unpooled ReLU mask: a pooled output cannot give the
        # pre-pool mask, which the backward recomputes instead
        ctx.save_for_backward(x, idx, codebook, bias,
                              y if relu and pool == 1 else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, idx, codebook, bias, y = ctx.saved_tensors
        if ctx.pool > 1:
            w = _ref.dequant_ref(idx, codebook, packed=ctx.packed).to(x.dtype)
            y_lin = matmul_f32(x.float(), w.float())
            del w
            g = _pre_pool_bwd(y_lin, bias, ctx.relu,
                              lambda v: _ref.max_pool_rows(v, ctx.pool), g)
        elif ctx.relu:
            g = g * (y > 0)
        dx, dcb = _pasm_bwd(x, idx, codebook, ctx.packed, g,
                            ctx.needs_input_grad[0], ctx.needs_input_grad[2])
        dbias = g.sum(dim=0).to(bias.dtype) if ctx.needs_input_grad[3] else None
        return dx, None, dcb, dbias, None, None, None, None, None


def pasm_matmul(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    gather: str = "take",
    mesh=None,
    pool: int = 1,
    local_rows: bool = False,
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """``x @ t`` on the fused-dequant kernel K1.  x ``(..., K)`` → ``(..., N)`` f32.

    ``bias (N,)`` / ``relu`` fuse into the kernel epilogue.  ``pool > 1``
    needs a 2-D ``x`` with **window-major** rows (each consecutive ``pool²``
    rows one window — the explicit conv path's ``_pool_order_patches``
    ordering) and returns the pooled ``(M/pool², N)``.  Differentiable in
    ``x``, ``t.codebook`` and ``bias`` (:class:`_PasmMatmul`).  ``mesh=``
    shards rows over ``data`` (padded up to the axis when unpooled; pooled
    rows must split in whole windows) and N over ``model`` when it divides
    (:func:`shard_gemm`), bitwise the single-device call.  ``whole = (M,
    N)`` of the unsharded call when ``x`` and ``t`` are one rank's block of
    it (the LM's tensor-parallel linears, ``params.block_matmul``): the
    kernel plans from it.
    """
    K, N = t.shape
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if pool > 1:
        _pool_rows(x, pool)
        x2 = x
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, K)

    def run(xl, idx, codebook, b, whole=None):
        xl, idx, codebook = xl.contiguous(), idx.contiguous(), codebook.contiguous()
        if _needs_grad(xl, codebook, b):
            return _PasmMatmul.apply(xl, idx, codebook, b, t.packed, gather,
                                     relu, pool, whole)
        return pasm_matmul_kernel_call(xl, idx, codebook, b, packed=t.packed,
                                       relu=relu, pool=pool, gather=gather,
                                       whole=whole)

    if mesh is None:
        y = run(x2, t.idx, t.codebook, bias, whole)
    else:
        y = _shard_rows(mesh, N, run, x2, t.idx, t.codebook, bias, pool=pool,
                        local_rows=local_rows)
    return y if pool > 1 else y.reshape(*lead, N)


def pas_matmul(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    mesh=None,
    pool: int = 1,
    local_rows: bool = False,
    whole: Optional[tuple] = None,
) -> torch.Tensor:
    """Paper-faithful PASM two-phase matmul on K3 (single dictionary).

    x ``(..., K)`` → ``(..., N)`` f32.  Packed indices are unpacked first
    (:func:`~repro_torch.core.pasm.logical_idx`): K3 takes one uint8 index
    per weight.  ``bias (N,)`` / ``relu`` ride the post-pass, and
    ``pool > 1`` max-reduces window-major row groups there too (2-D ``x``
    only — the same contract as :func:`pasm_matmul`, ``mesh=`` too; the
    PAS bins are per-block registers, so they replicate with the kernel);
    ``whole`` as in :func:`pasm_matmul`.
    """
    K, N = t.shape
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if pool > 1:
        _pool_rows(x, pool)
        x2 = x
    else:
        lead = x.shape[:-1]
        x2 = x.reshape(-1, K)

    def run(xl, idx, codebook, b, whole=None):
        return pas_matmul_kernel_call(xl.contiguous(), idx.contiguous(),
                                      codebook.contiguous(), b, relu=relu,
                                      pool=pool, whole=whole)

    idx = _pasm.logical_idx(t)
    if mesh is None:
        y = run(x2, idx, t.codebook, bias, whole)
    else:
        y = _shard_rows(mesh, N, run, x2, idx, t.codebook, bias, pool=pool,
                        local_rows=local_rows)
    return y if pool > 1 else y.reshape(*lead, N)


def _pool_rowmajor(y: torch.Tensor, geom: ConvGeom, batch: int) -> torch.Tensor:
    """Row-major conv output ``(B·P, N) → (B·P_out, N)`` pooled: the
    floor-cropped ``(pool, pool)`` window max the pooled backward routes
    ``g`` through (remainder pixels the kernel never computes get zero)."""
    p = geom.pool
    N = y.shape[-1]
    yb = y.reshape(batch, geom.oh, geom.ow, N)[:, : geom.ohp * p, : geom.owp * p]
    yb = yb.reshape(batch, geom.ohp, p, geom.owp, p, N)
    return yb.amax(dim=(2, 4)).reshape(batch * geom.P_out, N)


class _PasmConv(torch.autograd.Function):
    """Implicit-GEMM conv on K2 (+ ``bias``, ReLU, fused pool), with the
    JAX package's ``_pasm_conv`` / ``_pasm_conv_ep`` backward: explicit
    patches, the GEMM backward, dx back through im2colᵀ (col2im)."""

    @staticmethod
    def forward(ctx, x, idx, codebook, bias, geom, packed, gather, relu, whole):
        y = pasm_conv_kernel_call(x, idx, codebook, bias, geom=geom,
                                  packed=packed, relu=relu, gather=gather, whole=whole)
        ctx.geom, ctx.packed, ctx.relu = geom, packed, relu
        ctx.save_for_backward(x, idx, codebook, bias,
                              y if relu and geom.pool == 1 else None)
        return y

    @staticmethod
    def backward(ctx, g):
        x, idx, codebook, bias, y = ctx.saved_tensors
        geom = ctx.geom
        need_dx = ctx.needs_input_grad[0]
        g2 = g.reshape(-1, g.shape[-1])
        K = idx.shape[0] * (2 if ctx.packed else 1)
        with torch.enable_grad():
            xr = x.detach().requires_grad_(need_dx)
            patches = _ref.im2col_patches(
                xr, nhwc=geom.nhwc, ky=geom.ky, kx=geom.kx, stride=geom.stride,
                oh=geom.oh, ow=geom.ow, c_in=geom.c_in, pad=geom.pad)
        # the §3 pack-time K-pad rows carry zero activations
        pp = F.pad(patches.detach(), (0, K - geom.conv_k))
        if geom.pool > 1:
            w = _ref.dequant_ref(idx, codebook, packed=ctx.packed).to(pp.dtype)
            y_lin = matmul_f32(pp, w)
            del w
            g2 = _pre_pool_bwd(y_lin, bias, ctx.relu,
                               lambda v: _pool_rowmajor(v, geom, x.shape[0]), g2)
        elif ctx.relu:
            g2 = g2 * (y.reshape(g2.shape) > 0)
        dp, dcb = _pasm_bwd(pp, idx, codebook, ctx.packed, g2, need_dx,
                            ctx.needs_input_grad[2])
        dx = None
        if need_dx:
            dx, = torch.autograd.grad(patches, xr, dp[:, : geom.conv_k])
        dbias = g2.sum(dim=0).to(bias.dtype) if ctx.needs_input_grad[3] else None
        return dx, None, dcb, dbias, None, None, None, None, None


def pasm_conv2d(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    geom: ConvGeom,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    gather: str = "take",
    mesh=None,
    vmem_budget: Optional[int] = None,
    local_rows: bool = False,
) -> torch.Tensor:
    """Implicit-GEMM conv on K2: unpadded ``(B, img) → (B, P_out, N)``.

    One launch over the image batch; the patch tiles are gathered inside the
    kernel, so no ``(B·P, K)`` patch matrix exists.  ``bias (N,)`` /
    ``relu`` and ``geom.pool > 1`` fuse into the epilogue, so a whole
    conv/ReLU/pool stage is one launch storing only the pooled map.
    Differentiable in ``x``, ``t.codebook`` and ``bias`` (:class:`_PasmConv`:
    the backward materializes the patches and recomputes the pre-pool map).
    ``mesh=`` shards the batch over ``data`` (it must divide the axis:
    ``conv2d`` pads the remainder) and N over ``model`` when it divides;
    pool windows lie inside one image, so the fused pool shards unchanged.
    ``vmem_budget`` is kept for signature parity with the JAX package and is
    unused: K2 has no VMEM schedule to size.
    """
    del vmem_budget
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()

    def run(xl, idx, codebook, b, whole=None):
        xl, idx, codebook = xl.contiguous(), idx.contiguous(), codebook.contiguous()
        rows = None if whole is None else (whole[0] * geom.P_rows, whole[1])
        if _needs_grad(xl, codebook, b):
            return _PasmConv.apply(xl, idx, codebook, b, geom, t.packed, gather,
                                   relu, rows)
        return pasm_conv_kernel_call(
            xl, idx, codebook, b, geom=geom, packed=t.packed, relu=relu,
            gather=gather, whole=rows)

    if mesh is None:
        return run(x, t.idx, t.codebook, bias)
    _check_batch(x, mesh, local_rows)
    return shard_gemm(mesh, t.shape[1], run, x, t.idx, t.codebook, bias,
                      local_rows=local_rows)


def pas_conv2d(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    geom: ConvGeom,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    mesh=None,
    vmem_budget: Optional[int] = None,
    gather_output: bool = True,
    local_rows: bool = False,
) -> torch.Tensor:
    """Implicit-GEMM conv on the paper-faithful PAS formulation, K4.

    Unpadded ``(B, img) → (B, P_out, N)``, single dictionary, forward only;
    packed indices are unpacked first.  ``bias``/``relu``/``geom.pool`` and
    ``mesh=`` behave as in :func:`pasm_conv2d`.  ``vmem_budget`` and
    ``gather_output`` are kept for signature parity with the JAX package and
    are unused (no VMEM schedule; a sharded call always gathers N: it
    returns the global result).
    """
    del vmem_budget, gather_output
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()

    def run(xl, idx, codebook, b, whole=None):
        return pas_conv_kernel_call(
            xl.contiguous(), idx.contiguous(), codebook.contiguous(), b,
            geom=geom, relu=relu,
            whole=None if whole is None else (whole[0] * geom.P_rows, whole[1]))

    idx = _pasm.logical_idx(t)
    if mesh is None:
        return run(x, idx, t.codebook, bias)
    _check_batch(x, mesh, local_rows)
    return shard_gemm(mesh, t.shape[1], run, x, idx, t.codebook, bias,
                      local_rows=local_rows)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    bq: int = 128,
    bk: int = 128,
) -> torch.Tensor:
    """Fused flash attention on K5.  q (B,Sq,H,hd); k,v (B,Sk,KV,hd) → (B,Sq,H,hd).

    GQA: query heads are regrouped under their KV head,
    ``(B·KV, G, Sq, hd)``, so one K/V stream serves the whole group.
    ``bq``/``bk`` are the TPU kernel's tile hints, kept for signature
    parity and unused: the Hopper kernel keeps its own tile and masks the
    ragged Sq/Sk edges itself, so nothing is padded here.
    """
    del bq, bk
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if H % KV:
        raise ValueError(f"{H} query heads do not group under {KV} KV heads")
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4).reshape(B * KV, G, Sq, hd)
    kg = k.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    vg = v.permute(0, 2, 1, 3).reshape(B * KV, Sk, hd)
    o = flash_attention_kernel_call(qg.contiguous(), kg.contiguous(),
                                    vg.contiguous(), causal=causal, sk_orig=Sk)
    return o.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# roofline bookkeeping: the bytes the kernels move, on the port's plans
# ---------------------------------------------------------------------------


def matmul_flops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def _k_rows(t: _pasm.PASMTensor) -> int:
    """The reduction rows the stored indices hold (the §3 ``pad_k`` row
    included): what the kernels' x and idx span."""
    return int(t.idx.shape[0]) * (2 if t.packed else 1)


def pasm_hbm_bytes(t: _pasm.PASMTensor, M: int, act_bytes: int = 2) -> int:
    """Bytes one ``(M, K) @ (K, N)`` call of K1 moves: x, the stored
    indices, the dictionaries and the f32 output, plus the split-K partials K1 writes and its second pass reads back
    (``2 · K1Plan.scratch · 4``).  Plan-aware on the port's plan
    (``pasm_matmul.k1_plan``: ``act_bytes`` 2 is a bf16 x, 4 an f32 one);
    the kernels mask ragged edges, so no operand is padded.  On a shape
    with no split it is ``M·K·act_bytes + t.nbytes_weights + M·N·4``."""
    K, N = _k_rows(t), t.shape[1]
    plan = k1_plan(M, K, N, torch.bfloat16 if act_bytes == 2 else torch.float32,
                   packed=t.packed, groups=t.groups)
    return M * K * act_bytes + t.nbytes_weights + M * N * 4 + 2 * plan.scratch * 4


def conv_hbm_bytes(
    t: _pasm.PASMTensor,
    geom: ConvGeom,
    batch: int,
    ih: int,
    iw: int,
    *,
    implicit: bool,
    act_bytes: int = 4,
    shards: tuple = (1, 1),
    use_pas: bool = False,
) -> int:
    """Bytes one conv layer moves on a device, on the port's kernels and
    plans.

    ``implicit=True`` (K2, or K4 with ``use_pas``): the unpadded image is
    read once (the padding is masked in the kernel), ``batch·C·ih·iw``
    elements.  ``implicit=False`` (K1, or K3): the ``(B·P_rows, Kp)`` patch
    matrix is written by the front-end and read back by the kernel.  Both
    add the indices the kernel reads (K1/K2 the stored ones, K3/K4 one
    uint8 a weight), the f32 dictionaries, the f32 store of the pooled map
    and the split-K partials written and read back, on
    ``pasm_matmul.simt_plan`` (K2; ``k1_plan`` for K1) or
    ``pas_histogram.pas_plan`` (K3/K4).

    ``shards = (n_data, n_model)``: the bytes of one device on the sharded
    path — the batch over ``data`` (a remainder rounded up), N over
    ``model`` when it divides (else the weights replicate), the
    dictionaries on every device; the split count follows the whole
    call's N (``whole=``), as each shard's launch does.
    """
    Kp, N = _k_rows(t), t.shape[1]
    n_data, n_model = shards
    whole_m = batch * geom.P_rows
    batch = -(-batch // n_data)
    n = N // n_model if n_model > 1 and N % n_model == 0 else N
    M = batch * geom.P_rows
    if use_pas:
        idx_bytes = Kp * n
        plan = pas_plan(M, Kp, n, int(t.codebook.shape[-1]), geom.pool, whole=(whole_m, N))
    else:
        idx_bytes = int(t.idx.shape[0]) * n
        if implicit:
            plan = simt_plan(M, Kp, n, geom.pool, whole=(whole_m, N))
        else:
            plan = k1_plan(M, Kp, n, torch.bfloat16 if act_bytes == 2 else torch.float32,
                           geom.pool, packed=t.packed, groups=t.groups, whole=(whole_m, N))
    cb_bytes = int(t.codebook.numel()) * 4
    out_bytes = batch * geom.P_out * n * 4
    if implicit:
        x_bytes = batch * geom.c_in * ih * iw * act_bytes
    else:
        x_bytes = 2 * M * Kp * act_bytes  # im2col store + kernel stream
    return x_bytes + idx_bytes + cb_bytes + out_bytes + 2 * plan.scratch * 4
