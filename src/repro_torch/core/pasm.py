"""PASM weight-sharing: codebook quantization of dense weights.

Port of ``repro.core.pasm``.  Every weight of a layer is replaced by a
``log2(B)``-bit index into a codebook ("dictionary") of ``B`` shared values
(one dictionary per layer, the paper rule, or ``groups > 1`` dictionaries
along the reduction axis).

The quantized weight is a :class:`PASMTensor`: ``idx`` (uint8, optionally two
4-bit indices packed per byte, low nibble = even K row — byte-identical to
the JAX package) plus ``codebook`` (``(G, B)`` float32).  Dequantization
happens in the CUDA kernels (:mod:`repro_torch.kernels`) or via
:func:`dequantize` (the plain path).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core._f32 import matmul_f32

__all__ = [
    "PASMTensor",
    "kmeans_codebook",
    "quantize",
    "dequantize",
    "pack_int4",
    "unpack_int4",
    "bits_for_bins",
    "logical_idx",
    "quantize_like",
    "codebook_lookup",
    "KMEANS_CHUNK",
]

# k-means walks a group's weights in chunks of this many values, so its
# temporaries stay bounded whatever the group size: at 16 bins the
# ``(chunk, B)`` distances and the f32 one-hot take 256 MiB each.
KMEANS_CHUNK = 1 << 22


def bits_for_bins(bins: int) -> int:
    """Index bit-width for ``bins`` dictionary entries (paper: 2^2..2^8 bins)."""
    if bins < 2 or bins > 256:
        raise ValueError(f"PASM supports 2..256 bins, got {bins}")
    return 4 if bins <= 16 else 8


@dataclasses.dataclass(frozen=True)
class PASMTensor:
    """A weight-shared tensor: per-element bin indices + shared-value codebook.

    ``idx``       uint8 indices.  Logical shape is ``shape`` (always 2-D,
                  ``(K, N)`` = (reduction, output)).  When ``packed`` the K axis
                  holds two 4-bit indices per byte: physical ``(K//2, N)``.
    ``codebook``  ``(G, B)`` float32 shared weight values; group ``g`` covers
                  rows ``[g*K/G, (g+1)*K/G)`` of the reduction axis.
    """

    idx: torch.Tensor
    codebook: torch.Tensor
    shape: tuple
    bins: int
    bits: int
    packed: bool

    @property
    def groups(self) -> int:
        return int(self.codebook.shape[0])

    @property
    def nbytes_weights(self) -> int:
        """Device-memory bytes of the weight payload."""
        return int(self.idx.numel()) + int(self.codebook.numel()) * 4

    @property
    def nbytes_dense_bf16(self) -> int:
        K, N = self.shape
        return K * N * 2

    @property
    def compression_ratio(self) -> float:
        return self.nbytes_dense_bf16 / self.nbytes_weights


# ---------------------------------------------------------------------------
# k-means clustering (Lloyd iterations, quantile init — deterministic)
# ---------------------------------------------------------------------------


def _quantile_init(values: torch.Tensor, bins: int) -> torch.Tensor:
    """``jnp.quantile(values, (arange(B) + 0.5) / B)`` (linear interpolation)
    over any number of values, on one sort (``torch.quantile`` refuses
    inputs above 2**24 elements).  The arithmetic is XLA's: f32 positions
    and weights, and the interpolation contracted into one fused
    multiply-add, ``fma(hi, w_hi, lo · w_lo)`` (taken in f64 here).  Any
    NaN among the values makes every quantile NaN, as ``jnp.quantile``
    does, so a poisoned weight group gets all-NaN centroids and serves NaN
    (the sort puts a NaN last)."""
    dev = values.device
    qs = (torch.arange(bins, dtype=torch.float32, device=dev) + 0.5) / bins
    srt = torch.sort(values).values
    n = torch.tensor(float(values.numel()), dtype=torch.float32, device=dev)
    pos = qs * (n - 1)
    lo, hi = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - lo
    w_lo = 1 - w_hi
    last = values.numel() - 1
    lo_v = srt[lo.long().clamp(0, last)]
    hi_v = srt[hi.long().clamp(0, last)]
    q = (hi_v.double() * w_hi.double() + (lo_v * w_lo).double()).float()
    return torch.where(torch.isnan(srt[-1]), srt[-1], q)


def _assign(values: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each value, ties to the lower index (argmin's
    first minimum)."""
    return torch.argmin((values[:, None] - c[None, :]).abs_(), dim=1)


def _kmeans_1d(values: torch.Tensor, bins: int, iters: int) -> tuple:
    """1-D k-means on flat f32 ``values``. Returns (codebook (B,), idx (len,)).

    Quantile init, Lloyd iterations (an empty bin keeps its centroid), then
    the sorted centroids and a last assignment, as the JAX package.  The
    assignment and the per-bin counts and sums run over chunks of
    :data:`KMEANS_CHUNK` values, so any group size fits; the sums are taken
    in another order than the JAX one-hot product, which can move a centroid
    by an ulp (ROADMAP Queue 3).
    """
    centroids = _quantile_init(values, bins)
    chunks = values.split(KMEANS_CHUNK)
    ids = torch.arange(bins, device=values.device)
    for _ in range(iters):
        counts = torch.zeros(bins, dtype=torch.int64, device=values.device)
        sums = torch.zeros(bins, dtype=torch.float32, device=values.device)
        for v in chunks:
            hit = _assign(v, centroids)[:, None] == ids
            counts += hit.sum(dim=0)
            sums += matmul_f32(hit.to(torch.float32).T, v)
        # exact counts; as f32 they equal the JAX one-hot sums up to 2**24
        n = counts.clamp(min=1).to(torch.float32)
        centroids = torch.where(counts > 0, sums / n, centroids)
    centroids = torch.sort(centroids).values
    idx = torch.cat([_assign(v, centroids).to(torch.uint8) for v in chunks])
    return centroids, idx


def kmeans_codebook(w: torch.Tensor, bins: int, *, groups: int = 1,
                    iters: int = 16) -> tuple:
    """Cluster a 2-D weight ``(K, N)`` into ``groups`` codebooks of ``bins``.

    Returns ``(codebook (G, B) f32, idx (K, N) uint8)``.
    """
    if w.ndim != 2:
        raise ValueError(f"kmeans_codebook expects 2-D (K, N), got {tuple(w.shape)}")
    K, N = w.shape
    if K % groups != 0:
        raise ValueError(f"K={K} not divisible by groups={groups}")
    wg = w.to(torch.float32).reshape(groups, K // groups * N)
    cbs, idxs = zip(*(_kmeans_1d(v, bins, iters) for v in wg))
    idx = torch.stack(idxs).reshape(K, N).to(torch.uint8)
    return torch.stack(cbs), idx


# ---------------------------------------------------------------------------
# int4 packing (two indices per byte along the reduction axis)
# ---------------------------------------------------------------------------


def pack_int4(idx: torch.Tensor) -> torch.Tensor:
    """Pack ``(K, N)`` uint8 values < 16 into ``(K//2, N)``: lo nibble = even row."""
    K = idx.shape[0]
    if K % 2 != 0:
        raise ValueError(f"K={K} must be even to pack int4")
    lo = idx[0::2].to(torch.uint8)
    hi = idx[1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` → ``(2*Kp, N)`` uint8."""
    lo = packed & 0x0F
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=1)  # (Kp, 2, N)
    return out.reshape(packed.shape[0] * 2, *packed.shape[1:]).to(torch.uint8)


# ---------------------------------------------------------------------------
# quantize / dequantize
# ---------------------------------------------------------------------------


def quantize(
    w: torch.Tensor,
    bins: int = 16,
    *,
    groups: int = 1,
    iters: int = 16,
    pack: Optional[bool] = None,
) -> PASMTensor:
    """Post-training weight-share a 2-D weight (paper-faithful for groups=1)."""
    bits = bits_for_bins(bins)
    if pack is None:
        pack = bits == 4
    if pack and bits != 4:
        raise ValueError("packing requires bins <= 16")
    codebook, idx = kmeans_codebook(w, bins, groups=groups, iters=iters)
    if pack:
        idx = pack_int4(idx)
    return PASMTensor(idx=idx, codebook=codebook, shape=tuple(w.shape),
                      bins=bins, bits=bits, packed=bool(pack))


def logical_idx(t: PASMTensor) -> torch.Tensor:
    """The ``(K, N)`` uint8 index array regardless of packing."""
    return unpack_int4(t.idx) if t.packed else t.idx


def codebook_lookup(codebook: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(G, B)`` codebook + logical ``(K, N)`` indices → ``(K, N)`` values.

    Row ``k`` reads dictionary ``g = k // (K / G)`` — the grouping rule every
    container and kernel shares.
    """
    G, B = codebook.shape
    K = idx.shape[0]
    off = torch.arange(G, device=idx.device).repeat_interleave(K // G) * B
    return codebook.reshape(-1)[idx.long() + off[:, None]]


def dequantize(t: PASMTensor, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense ``(K, N)`` weight — the weight-shared MAC's view."""
    return codebook_lookup(t.codebook, logical_idx(t)).to(dtype)


def quantize_like(t: PASMTensor, w: torch.Tensor) -> PASMTensor:
    """Re-assign ``w`` to the nearest entries of an existing codebook."""
    K, N = t.shape
    G = t.groups
    wg = w.to(torch.float32).reshape(G, K // G, N)
    d = (wg[..., None] - t.codebook[:, None, None, :]).abs()
    idx = torch.argmin(d, dim=-1).to(torch.uint8).reshape(K, N)
    if t.packed:
        idx = pack_int4(idx)
    return dataclasses.replace(t, idx=idx)
