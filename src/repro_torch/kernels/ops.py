"""Op wrappers around the Hopper kernels: shapes, layouts and the tile plan.

Port of the forward halves of ``repro.kernels.ops``: :func:`pasm_matmul`
(K1) and :func:`pasm_conv2d` (K2), and the paper-faithful two-phase
:func:`pas_matmul` (K3) and :func:`pas_conv2d` (K4), each with the fused
``bias`` / ``relu`` epilogue and the window-major ``pool``; and
:func:`flash_attention` (K5).  Forward only:
the PASM pair's custom VJPs come with the QAT/training slice (ROADMAP Queue
1 item 7), the PAS pair is forward-only in the JAX package too, and the
wrappers raise on tensors that require grad.

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
ported: K2 gathers from global memory, so any image size runs.  ``mesh=``
belongs to the distribution slice (ROADMAP Queue 1 item 10) and raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import pasm as _pasm
from repro_torch.core.params import NOT_PORTED_MESH
from repro_torch.kernels.flash_attention import flash_attention_kernel_call
from repro_torch.kernels.pas_histogram import (
    pas_conv_kernel_call,
    pas_matmul_kernel_call,
)
from repro_torch.kernels.pasm_matmul import (
    ConvGeom,
    pasm_conv_kernel_call,
    pasm_matmul_kernel_call,
    pool_plan_exists,
)

__all__ = ["pasm_matmul", "pas_matmul", "pasm_conv2d", "pas_conv2d",
           "flash_attention", "ConvGeom", "pool_plan_exists"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(NOT_PORTED_MESH)


def _pool_rows(x: torch.Tensor, pool: int) -> None:
    if x.ndim != 2 or x.shape[0] % (pool * pool):
        raise ValueError(
            "pool= needs a 2-D window-major x (pool² consecutive rows "
            f"per window), got shape {tuple(x.shape)} with pool={pool}"
        )


def pasm_matmul(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    gather: str = "take",
    mesh=None,
    pool: int = 1,
) -> torch.Tensor:
    """``x @ t`` on the fused-dequant kernel K1.  x ``(..., K)`` → ``(..., N)`` f32.

    ``bias (N,)`` / ``relu`` fuse into the kernel epilogue.  ``pool > 1``
    needs a 2-D ``x`` with **window-major** rows (each consecutive ``pool²``
    rows one window — the explicit conv path's ``_pool_order_patches``
    ordering) and returns the pooled ``(M/pool², N)``.
    """
    _no_mesh(mesh)
    K, N = t.shape
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if pool > 1:
        _pool_rows(x, pool)
        return pasm_matmul_kernel_call(
            x.contiguous(), t.idx.contiguous(), t.codebook.contiguous(), bias,
            packed=t.packed, relu=relu, pool=pool, gather=gather)
    lead = x.shape[:-1]
    y = pasm_matmul_kernel_call(
        x.reshape(-1, K).contiguous(), t.idx.contiguous(),
        t.codebook.contiguous(), bias,
        packed=t.packed, relu=relu, gather=gather)
    return y.reshape(*lead, N)


def pas_matmul(
    x: torch.Tensor,
    t: _pasm.PASMTensor,
    *,
    bias: Optional[torch.Tensor] = None,
    relu: bool = False,
    mesh=None,
    pool: int = 1,
) -> torch.Tensor:
    """Paper-faithful PASM two-phase matmul on K3 (single dictionary).

    x ``(..., K)`` → ``(..., N)`` f32.  Packed indices are unpacked first
    (:func:`~repro_torch.core.pasm.logical_idx`): K3 takes one uint8 index
    per weight.  ``bias (N,)`` / ``relu`` ride the post-pass, and
    ``pool > 1`` max-reduces window-major row groups there too (2-D ``x``
    only — the same contract as :func:`pasm_matmul`).
    """
    _no_mesh(mesh)
    K, N = t.shape
    idx = _pasm.logical_idx(t).contiguous()
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if pool > 1:
        _pool_rows(x, pool)
        return pas_matmul_kernel_call(x.contiguous(), idx,
                                      t.codebook.contiguous(), bias,
                                      relu=relu, pool=pool)
    lead = x.shape[:-1]
    y = pas_matmul_kernel_call(x.reshape(-1, K).contiguous(), idx,
                               t.codebook.contiguous(), bias, relu=relu)
    return y.reshape(*lead, N)


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
) -> torch.Tensor:
    """Implicit-GEMM conv on K2: unpadded ``(B, img) → (B, P_out, N)``.

    One launch over the image batch; the patch tiles are gathered inside the
    kernel, so no ``(B·P, K)`` patch matrix exists.  ``bias (N,)`` /
    ``relu`` and ``geom.pool > 1`` fuse into the epilogue, so a whole
    conv/ReLU/pool stage is one launch storing only the pooled map.
    ``vmem_budget`` is kept for signature parity with the JAX package and is
    unused: K2 has no VMEM schedule to size.
    """
    del vmem_budget
    _no_mesh(mesh)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    return pasm_conv_kernel_call(
        x.contiguous(), t.idx.contiguous(), t.codebook.contiguous(), bias,
        geom=geom, packed=t.packed, relu=relu, gather=gather)


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
) -> torch.Tensor:
    """Implicit-GEMM conv on the paper-faithful PAS formulation, K4.

    Unpadded ``(B, img) → (B, P_out, N)``, single dictionary, forward only;
    packed indices are unpacked first.  ``bias``/``relu``/``geom.pool`` fuse
    as in :func:`pasm_conv2d`.  ``vmem_budget`` and ``gather_output`` are
    kept for signature parity with the JAX package and are unused (no VMEM
    schedule; ``gather_output`` only shapes a sharded call).
    """
    del vmem_budget, gather_output
    _no_mesh(mesh)
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    return pas_conv_kernel_call(
        x.contiguous(), _pasm.logical_idx(t).contiguous(),
        t.codebook.contiguous(), bias, geom=geom, relu=relu)


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
