"""Plain PyTorch versions of the kernels: the CPU path and the card oracle.

Port of ``repro.kernels.ref``.  On a CPU tensor the kernel wrappers in
:mod:`repro_torch.kernels.pasm_matmul` run these; on the card
``chip_smoke.py`` and the gpu-marked tests hold each CUDA kernel against
them on the same inputs.  Every float32 product runs with TF32 off.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import pasm as _pasm
from repro_torch.core._f32 import matmul_f32

__all__ = ["pasm_matmul_ref", "pas_matmul_ref", "dequant_ref", "apply_epilogue",
           "im2col_patches", "max_pool_rows"]


def im2col_patches(
    x: torch.Tensor, *, nhwc: bool, ky: int, kx: int, stride: int,
    oh: int, ow: int, c_in: int, pad: tuple,
) -> torch.Tensor:
    """Explicit batched im2col, geometry resolved: ``(B, img) → (B·P, K)``.

    NCHW flattens in the paper's ``(c, ky, kx)`` loop order, NHWC
    channels-minor ``(ky, kx, c)``; ``pad = ((lo_h, hi_h), (lo_w, hi_w))``
    is the spatial zero-pad.
    """
    (plh, phh), (plw, phw) = pad
    if plh or phh or plw or phw:
        # F.pad lists the last dim first
        cfg = (0, 0, plw, phw, plh, phh) if nhwc else (plw, phw, plh, phh)
        x = F.pad(x, cfg)
    dev = x.device
    kyr, kxr = torch.arange(ky, device=dev), torch.arange(kx, device=dev)
    oyr = torch.arange(oh, device=dev) * stride
    oxr = torch.arange(ow, device=dev) * stride
    if nhwc:
        rows = oyr[:, None, None, None] + kyr[None, None, :, None]  # (oh,1,KY,1)
        cols = oxr[None, :, None, None] + kxr[None, None, None, :]  # (1,ow,1,KX)
        patches = x[:, rows, cols, :]  # (B, oh, ow, KY, KX, C)
    else:
        c = torch.arange(c_in, device=dev)[None, None, :, None, None]
        rows = oyr[:, None, None, None, None] + kyr[None, None, None, :, None]
        cols = oxr[None, :, None, None, None] + kxr[None, None, None, None, :]
        patches = x[:, c, rows, cols]  # (B, oh, ow, C, KY, KX)
    return patches.reshape(x.shape[0] * oh * ow, c_in * ky * kx)


def apply_epilogue(y: torch.Tensor, bias, relu: bool) -> torch.Tensor:
    """The bias/ReLU epilogue the kernels fuse, as plain torch.

    Also the einsum engine's epilogue in :func:`repro_torch.core.conv.conv2d`.
    The ReLU clamp keeps ``y``'s dtype.
    """
    if bias is not None:
        y = y + bias
    if relu:
        y = torch.clamp(y, min=0)
    return y


def max_pool_rows(y: torch.Tensor, pool: int) -> torch.Tensor:
    """Window-major row pooling: ``(R·pool², N) → (R, N)`` max per group.

    The plain version of the kernels' fused max-pool epilogue: each
    consecutive ``pool²`` rows are one non-overlapping pool window.
    """
    if pool == 1:
        return y
    pw = pool * pool
    return y.reshape(y.shape[0] // pw, pw, y.shape[1]).amax(dim=1)


def dequant_ref(idx: torch.Tensor, codebook: torch.Tensor, *,
                packed: bool) -> torch.Tensor:
    """(K, N) f32 weights from indices + (G, B) codebook."""
    if packed:
        idx = _pasm.unpack_int4(idx)
    return _pasm.codebook_lookup(codebook, idx)


def pasm_matmul_ref(x: torch.Tensor, idx: torch.Tensor, codebook: torch.Tensor,
                    *, packed: bool) -> torch.Tensor:
    """The dequant-fused GEMM's plain version: dequantize, then f32 GEMM."""
    w = dequant_ref(idx, codebook, packed=packed).to(x.dtype)
    return matmul_f32(x, w).to(torch.float32)


def pas_matmul_ref(x: torch.Tensor, idx: torch.Tensor,
                   codebook: torch.Tensor) -> torch.Tensor:
    """The two-phase PAS GEMM's plain version: histogram bins, then post-pass.

    ``x (M, K) · idx (K, N) · codebook (1, B) → (M, N)`` f32.  The PAS phase
    is one f32 product with the ``(K, N·B)`` one-hot of ``idx``; an index
    ``>= B`` has an all-zero one-hot row and adds nothing, as
    ``jax.nn.one_hot`` does in the JAX reference (``F.one_hot`` would raise).
    """
    K, N = idx.shape
    B = codebook.shape[-1]
    bins = torch.arange(B, device=idx.device)
    onehot = (idx[..., None].long() == bins).to(x.dtype).reshape(K, N * B)
    s = matmul_f32(x, onehot).reshape(x.shape[0], N, B).to(torch.float32)
    return matmul_f32(s, codebook.reshape(-1).to(torch.float32))
