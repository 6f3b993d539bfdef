"""K5: the GQA flash-attention forward on Hopper, and its plain version.

:func:`flash_attention_kernel_call` launches ``csrc/flash_attention.cu``.  It
replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention_kernel_call``
(``_kernel``): ``q (BKV, G, Sq, hd)`` with the query heads regrouped under
their KV head, ``k, v (BKV, Sk, hd)``, f32 or bf16 (f16 on the f32 route);
an f32 online softmax scaled by ``hd ** -0.5``; keys at or past
``sk_orig`` masked; an optional causal mask ``key <= query``;
``acc / max(l, 1e-30)``; output in ``q``'s dtype.

The TPU kernel kept the whole K/V block resident in VMEM and needed Sq and
Sk padded to its tiles.  The CUDA kernel streams K/V tiles through shared
memory and masks the ragged Sq and Sk edges itself, so nothing is padded;
``bq``/``bk`` stay on :func:`repro_torch.kernels.ops.flash_attention` as the
TPU's tile hints and the kernel keeps its own tiles (64 query rows, 128 on
the f32 route at hd 128).
Head dims: :data:`HEAD_DIMS` (every attention arch of the registry).

Two routes, by dtype.  f32 runs SIMT f32 FMA, register-blocked like an SGEMM
(a thread owns 4 query rows of S and of O, K/V tiles by ``cp.async`` into a
two-stage ring).  bf16 runs on the tensor cores (``mma.sync`` m16n8k16, f32
accumulate, FA2's layout: 16 query rows a warp, K/V by ``cp.async`` into a
two-stage ring, the online softmax on the accumulator fragments).  There P
is rounded to bf16 before P·V, as :func:`repro_torch.nn.attention.gqa_attention`
rounds it to v's dtype; the JAX kernel keeps P in f32, so the bf16 route is
held to its plain version with ``|Δ| ≤ 2^-7·(|plain| + Σ_j p_j·|v_j|)``
(:data:`BF16_TOL`; the sum is the plain version on ``|v|``), the f32 route
with ``1e-5``.

On a CPU tensor the wrapper runs :func:`flash_attention_plain`; on a CUDA
tensor it launches the kernel or raises.  Each launch adds one to
``launches["flash_attention"]`` (the counter dict of
:mod:`repro_torch.kernels.pasm_matmul`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core._f32 import matmul_f32
from repro_torch.kernels.pasm_matmul import _on, _raise_on, _stream, launches

__all__ = ["flash_attention_kernel_call", "flash_attention_plain", "HEAD_DIMS"]

# the head dims the kernel is compiled for (template HD in csrc): every
# head dim of the registry's attention archs
HEAD_DIMS = (16, 32, 64, 80, 128, 192, 256)
DTYPES = (torch.float32, torch.bfloat16)
# the bf16 route against flash_attention_plain: P is rounded to bf16 (2**-9
# relative each, so 2**-9·Σ_j p_j·|v_j| at most) before P·V, then the output
# to bf16 (2**-9): |Δ| <= BF16_TOL·(|plain| + Σ_j p_j·|v_j|)
BF16_TOL = 2.0 ** -7
_NEG_INF = -1e30


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sk_orig: Optional[int] = None) -> torch.Tensor:
    """K5's plain version: the same function in whole-matrix PyTorch.

    Scores ``(q·scale) kᵀ`` in f32 (inputs widened, TF32 off), masked
    (``key < sk_orig``, and ``key <= query`` when causal) to ``-1e30``,
    softmaxed in f32, times ``v`` in f32; output in ``q``'s dtype.
    """
    BKV, G, Sq, hd = q.shape
    Sk = k.shape[1]
    kvalid = Sk if sk_orig is None else sk_orig
    qf = q.float() * (hd ** -0.5)
    s = matmul_f32(qf, k.float()[:, None].transpose(-1, -2))  # (BKV,G,Sq,Sk)
    k_pos = torch.arange(Sk, device=q.device)
    mask = (k_pos < kvalid)[None, :].expand(Sq, Sk)
    if causal:
        mask = mask & (torch.arange(Sq, device=q.device)[:, None] >= k_pos[None, :])
    s = torch.where(mask, s, torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return matmul_f32(p, v.float()[:, None]).to(q.dtype)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads 16-byte vectors: a contiguous copy on a 16-byte
    boundary (a fresh allocation is one; an offset view may not be)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_P, _I = ctypes.c_void_p, ctypes.c_int


def flash_attention_kernel_call(
    q: torch.Tensor,  # (BKV, G, Sq, hd)
    k: torch.Tensor,  # (BKV, Sk, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    sk_orig: Optional[int] = None,
) -> torch.Tensor:
    """K5: ``(BKV, G, Sq, hd) × (BKV, Sk, hd)² → (BKV, G, Sq, hd)``.

    ``sk_orig`` (default ``Sk``) is the number of real keys: keys at or past
    it are masked, as the TPU kernel masked its pad keys.  f16 operands run
    the f32 route on their exact widening, the output rounded back to f16:
    the JAX kernel computes in f32 from any input dtype.
    """
    if q.dtype == torch.float16 and k.dtype == v.dtype == q.dtype:
        return flash_attention_kernel_call(
            q.float(), k.float(), v.float(), causal=causal,
            sk_orig=sk_orig).to(torch.float16)
    if q.ndim != 4 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"expected q (BKV,G,Sq,hd), k = v (BKV,Sk,hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BKV, G, Sq, hd = q.shape
    Sk = k.shape[1]
    if k.shape[0] != BKV or k.shape[2] != hd:
        raise ValueError(f"k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a dtype in {DTYPES + (torch.float16,)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    kvalid = Sk if sk_orig is None else int(sk_orig)
    if not 0 < kvalid <= Sk:
        raise ValueError(f"sk_orig={sk_orig} must be in [1, Sk={Sk}]")
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise RuntimeError("the flash-attention kernel is forward-only; call "
                           "under torch.no_grad() or detach the inputs")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v on different devices")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, sk_orig=kvalid)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not compiled; the kernel takes {HEAD_DIMS}")
    if BKV > 65535 or G > 65535:
        raise ValueError(f"the launch grid takes at most 65535 (b·kv, g), got "
                         f"{BKV}, {G}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if Sq == 0:
        return out
    from repro_torch.kernels import _build

    fn = _build.entry_point("flash_attention", "flash_attention_launch",
                            [_P] * 4 + [_I] * 8 + [ctypes.c_float, _P])
    with _on(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BKV, G, Sq, Sk, kvalid, hd, int(causal),
                 int(q.dtype == torch.bfloat16), hd ** -0.5, _stream(q.device))
    _raise_on(err, "flash_attention")
    launches["flash_attention"] += 1
    return out
