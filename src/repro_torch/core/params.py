"""PasmParams — the one weight-shared parameter container, conv to dense.

Port of ``repro.core.params``.  A tagged weight: ``dense`` (a plain
``(…, K, N)`` matrix), weight-``shared`` (uint8 bin indices + a ``(…, G, B)``
codebook) or int4-``packed`` (two 4-bit indices per byte along K, with the
§3 K-pad applied at :meth:`PasmParams.pack` so odd reductions pack).
:func:`matmul` is the dispatch every quantized dense layer routes through.

:class:`repro_torch.core.pasm.PASMTensor` is the physical GEMM operand the
kernels take (pad-inclusive shapes); :meth:`PasmParams.gemm_tensor` bridges
the two.  :class:`repro_torch.core.conv.ConvParams` is the conv-geometry
face of this container.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import pasm as _pasm
from repro_torch.core._f32 import widened_matmul

__all__ = [
    "PasmParams",
    "KINDS",
    "MATMUL_IMPLS",
    "as_params",
    "is_quantized",
    "matmul",
    "embed_lookup",
    "dense_weight",
    "dense_stack",
    "tp_linear",
    "held_block",
    "block_matmul",
]

KINDS = ("dense", "shared", "packed")
# matmul impl names: plain tensors / dense params take the dense product
# under every impl — quantized params dispatch on it.
MATMUL_IMPLS = ("dense", "dequant", "kernel", "pas_kernel")

Weight = Union[torch.Tensor, "PasmParams", _pasm.PASMTensor]


@dataclasses.dataclass(frozen=True)
class PasmParams:
    """Tagged matmul weights: ``dense`` | weight-``shared`` | int4-``packed``.

    ``dense``   ``w (…, K, N)``; ``idx``/``codebook`` None.
    ``shared``  ``idx (…, K, N) uint8`` + ``codebook (…, G, B)`` f32.
    ``packed``  ``idx (…, (K+pad_k)//2, N) uint8`` — two 4-bit indices per
                byte along K; ``pad_k`` records the §3 K-pad row appended so
                an odd reduction packs (callers pad the matching activation
                column with zeros, which :func:`matmul` does).
    ``bias``    ``(…, N)`` or None on every kind — never shared (paper §4).
    ``shape``   the logical ``(K, N)``.
    ``lead``    under a mesh, the global leading (stack) dims of a leaf
                whose leading dim this rank holds a block of (an expert
                stack's E over ``model``,
                :func:`repro_torch.models.sharding.place_params`); ``None``
                when the held leading dims are the global ones.
    """

    w: Optional[torch.Tensor] = None
    idx: Optional[torch.Tensor] = None
    codebook: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    kind: str = "dense"
    shape: tuple = ()
    bins: Optional[int] = None
    pad_k: int = 0
    lead: Optional[tuple] = None

    # -- constructors -------------------------------------------------------

    @classmethod
    def dense(cls, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None):
        """Non-weight-shared params from a plain ``(…, K, N)`` matrix."""
        if w.ndim < 2:
            raise ValueError(f"dense params need a (…, K, N) matrix, got {tuple(w.shape)}")
        return cls(w=w, bias=bias, kind="dense", shape=tuple(w.shape[-2:]))

    @classmethod
    def shared(cls, idx: torch.Tensor, codebook: torch.Tensor, *,
               bias: Optional[torch.Tensor] = None):
        """Weight-shared params from existing bin indices + dictionary.

        ``idx (…, K, N)`` uint8; ``codebook (B,)`` (the single-dictionary
        paper rule) or ``(…, G, B)``.  Leading dims must agree.
        """
        if idx.ndim < 2:
            raise ValueError(f"idx must be (…, K, N), got {tuple(idx.shape)}")
        if codebook.ndim == 1:
            codebook = codebook[None]  # (B,) ≡ the single-dictionary rule
        if codebook.ndim != idx.ndim:
            raise ValueError(
                f"codebook rank {tuple(codebook.shape)} does not match idx "
                f"{tuple(idx.shape)}: leading stack dims must agree"
            )
        K = int(idx.shape[-2])
        G = int(codebook.shape[-2])
        if K % G:
            raise ValueError(f"K={K} not divisible by codebook groups={G}")
        return cls(idx=idx.to(torch.uint8), codebook=codebook, bias=bias,
                   kind="shared", shape=tuple(idx.shape[-2:]),
                   bins=int(codebook.shape[-1]))

    @classmethod
    def quantize(cls, w: torch.Tensor, bins: int = 16, *, groups: int = 1,
                 bias: Optional[torch.Tensor] = None, iters: int = 16):
        """K-means weight-share a dense ``(…, K, N)`` matrix (per leading
        slice).  Does not pack — call :meth:`pack` for the int4 payload.
        A ``meta`` matrix gives ``meta`` indices and dictionaries of the
        shapes k-means would give, and :meth:`pack` then the packed ones:
        the shape-only tree of the port's dry run."""
        if w.ndim < 2:
            raise ValueError(f"quantize needs a (…, K, N) matrix, got {tuple(w.shape)}")
        K, N = w.shape[-2:]
        lead = tuple(w.shape[:-2])
        if w.is_meta:
            return cls.shared(torch.empty(lead + (K, N), dtype=torch.uint8, device="meta"),
                              torch.empty(lead + (groups, bins), device="meta"), bias=bias)
        cbs, idxs = zip(*(
            _pasm.kmeans_codebook(m, bins, groups=groups, iters=iters)
            for m in w.reshape(-1, K, N)
        ))
        return cls.shared(torch.stack(idxs).reshape(lead + (K, N)),
                          torch.stack(cbs).reshape(lead + (groups, bins)),
                          bias=bias)

    def pack(self) -> "PasmParams":
        """int4-pack the dictionary indices (two 4-bit indices per byte).

        An odd ``K`` gets the §3 K-pad first: one pad row is appended, mapped
        to a reserved all-zero codebook bin when representable
        (``bins < 16``) or to bin 0 otherwise — exact either way, because
        the paired activation column is zero.
        """
        if self.kind != "shared":
            raise ValueError(
                f"pack() needs shared params (got {self.kind!r}); "
                "quantize() dense weights first"
            )
        if self.bins > 16:
            raise ValueError(f"int4 packing needs bins <= 16, got {self.bins}")
        K, N = self.shape
        G = self.groups
        if G > 1 and (K // G) % 2:
            raise ValueError(
                "packed int4 needs an even per-group reduction length, got "
                f"K={K} over {G} groups"
            )
        idx, codebook, bins, pad_k = self.idx, self.codebook, self.bins, 0
        if K % 2:
            pad_k = 1
            if bins < 16:
                codebook = F.pad(codebook, (0, 1))  # reserved 0-bin
                pad_bin, bins = bins, bins + 1
            else:
                pad_bin = 0  # inert anyway: the paired x column is zero
            idx = F.pad(idx, (0, 0, 0, 1), value=pad_bin)
        lead = tuple(idx.shape[:-2])
        flat = idx.reshape((-1,) + tuple(idx.shape[-2:]))
        packed = torch.stack([_pasm.pack_int4(m) for m in flat])
        return PasmParams(idx=packed.reshape(lead + ((K + pad_k) // 2, N)),
                          codebook=codebook, bias=self.bias, kind="packed",
                          shape=self.shape, bins=bins, pad_k=pad_k)

    # -- views --------------------------------------------------------------

    @property
    def groups(self) -> int:
        """Codebook groups along the reduction axis (1 = paper rule)."""
        return 1 if self.codebook is None else int(self.codebook.shape[-2])

    @property
    def packed(self) -> bool:
        return self.kind == "packed"

    @property
    def bits(self) -> Optional[int]:
        """Index bit-width (None for dense params)."""
        if self.kind == "dense":
            return None
        return 4 if self.packed else _pasm.bits_for_bins(self.bins)

    def select(self, i: int) -> "PasmParams":
        """Slice ``i`` of the leading stack dim (one expert of an ``(E, K,
        N)`` stack): every array field indexed at ``i``, a view that copies
        nothing.  ``kind``, ``shape``, ``bins``, ``pad_k`` and the packed
        layout are the stack's; the slice keeps its own dictionaries."""
        if len(self._lead) < 1:
            raise ValueError(f"select() needs stacked params, got lead dims {self._lead}")
        pick = lambda a: None if a is None else a[i]  # noqa: E731
        return dataclasses.replace(self, w=pick(self.w), idx=pick(self.idx),
                                   codebook=pick(self.codebook), bias=pick(self.bias),
                                   lead=None)

    def gemm_tensor(self) -> _pasm.PASMTensor:
        """The dictionary as the physical GEMM operand, shape
        ``(K + pad_k, N)`` — callers pad the activation by ``pad_k``."""
        if self.kind == "dense":
            raise ValueError(
                "dense params have no dictionary; use the dense matmul path"
            )
        K, N = self.shape
        return _pasm.PASMTensor(
            idx=self.idx, codebook=self.codebook.to(torch.float32),
            shape=(K + self.pad_k, N), bins=self.bins,
            bits=4 if self.packed else _pasm.bits_for_bins(self.bins),
            packed=self.packed,
        )

    def dense_matrix(self, dtype=None) -> torch.Tensor:
        """The logical dense ``(…, K, N)`` weight (§3 pad rows removed)."""
        if self.kind == "dense":
            return self.w if dtype is None else self.w.to(dtype)
        K, N = self.shape

        def one(ix, cb):
            if self.packed:
                ix = _pasm.unpack_int4(ix)
            return _pasm.codebook_lookup(cb, ix)[:K]

        lead = tuple(self.idx.shape[:-2])
        if lead:
            out = torch.stack([
                one(ix, cb) for ix, cb in zip(
                    self.idx.reshape((-1,) + tuple(self.idx.shape[-2:])),
                    self.codebook.reshape((-1,) + tuple(self.codebook.shape[-2:])),
                )
            ]).reshape(lead + (K, N))
        else:
            out = one(self.idx, self.codebook)
        return out.to(torch.float32 if dtype is None else dtype)

    # -- byte accounting ----------------------------------------------------

    @property
    def _lead(self) -> tuple:
        a = self.w if self.kind == "dense" else self.idx
        return tuple(a.shape[:-2])

    @property
    def nbytes_weights(self) -> int:
        """Device-memory bytes of the weight payload."""
        if self.kind == "dense":
            return int(self.w.numel()) * self.w.element_size()
        return int(self.idx.numel()) + int(self.codebook.numel()) * 4

    @property
    def nbytes_dense_bf16(self) -> int:
        lead = 1
        for d in self._lead:
            lead *= int(d)
        K, N = self.shape
        return lead * K * N * 2

    @property
    def compression_ratio(self) -> float:
        """Dense-bf16 bytes over stored bytes — the bins-vs-bytes trade-off."""
        return self.nbytes_dense_bf16 / self.nbytes_weights


# ---------------------------------------------------------------------------
# the dispatch surface
# ---------------------------------------------------------------------------


def as_params(w: Weight) -> PasmParams:
    """Coerce any weight leaf into the container (a raw PASMTensor wraps with
    its physical shape as the logical one, ``pad_k = 0``)."""
    if isinstance(w, PasmParams):
        return w
    if isinstance(w, _pasm.PASMTensor):
        return PasmParams(idx=w.idx, codebook=w.codebook,
                          kind="packed" if w.packed else "shared",
                          shape=tuple(w.shape), bins=w.bins)
    if w.ndim >= 2:
        return PasmParams.dense(w)
    return PasmParams(w=w, kind="dense", shape=tuple(w.shape))


def is_quantized(w) -> bool:
    """Whether a weight leaf carries a dictionary (vs a plain dense matrix)."""
    if isinstance(w, PasmParams):
        return w.kind != "dense"
    return isinstance(w, _pasm.PASMTensor)


def matmul(x: torch.Tensor, w: Weight, *, impl: str = "dense",
           bias: Optional[torch.Tensor] = None, relu: bool = False,
           mesh=None) -> torch.Tensor:
    """``x @ w`` for any weight leaf — the dense-layer dispatch.

    Plain tensors and ``dense`` params always take the dense product.
    Quantized params dispatch on ``impl``: ``dequant`` (dictionary gather +
    dense product, the oracle), ``kernel`` (the fused-dequant GEMM, K1, with
    bias/ReLU fused) or ``pas_kernel`` (the paper-faithful two-phase PAS
    GEMM, K3; single-dictionary only).  ``mesh=`` (a ``("data", "model")``
    :class:`~repro_torch.launch.mesh.Mesh`) runs the kernel paths through
    the sharded dispatch conv uses — rows over ``data``, N over ``model``
    when divisible, the global result on every rank — bitwise equal to the
    single-device call.  Packed params with a §3 K-pad get their zero
    activation column appended here.  Output dtype follows ``x``.
    """
    if impl not in MATMUL_IMPLS:
        raise ValueError(f"impl must be one of {MATMUL_IMPLS}, got {impl!r}")
    p = as_params(w)
    if bias is None:
        bias = p.bias
    return _matmul_f32(x, p, impl, bias, relu, mesh).to(x.dtype)


def tp_linear(x: torch.Tensor, w: Weight, *, impl: str, mesh,
              rows: Optional[int] = None) -> torch.Tensor:
    """The LM's tensor-parallel linear, run SPMD on rank-local operands,
    with no gather between a column-parallel layer and the row-parallel one
    after it.  ``x`` holds this rank's rows (``rows``: the unsharded call's
    row count, which the kernels plan from; default ``x``'s own) and ``w``
    is a placed leaf (:func:`repro_torch.models.sharding.place_params`)
    holding this rank's block of its logical ``shape``.

    An N block (column-parallel) gives this rank's N block of the output,
    bitwise the unsharded call's columns.  A K block (row-parallel) takes
    ``x`` whole or as this rank's K block, all-reduces its f32 partial over
    ``model`` and rounds once: within one ulp of ``x``'s dtype plus
    ``1e-5·(|x|@|W|)`` of the unsharded call (another order of the f32
    sum).  A leaf held whole (it did not divide the axis) computes the
    whole product on every rank.  The leaf's bias (an N block's own
    columns) is added after the sum; the output dtype follows ``x``."""
    if impl not in MATMUL_IMPLS:
        raise ValueError(f"impl must be one of {MATMUL_IMPLS}, got {impl!r}")
    p = as_params(w)
    y, k_split = block_matmul(x, p, impl=impl, mesh=mesh, rows=rows)
    if k_split:
        from repro_torch.launch.mesh import all_reduce

        y = all_reduce(y, mesh, "model")
    bias = p.bias
    if bias is not None and bias.shape[-1] != y.shape[-1]:  # an N block's own
        bias = bias.narrow(-1, mesh.index("model") * y.shape[-1], y.shape[-1])
    from repro_torch.kernels.ref import apply_epilogue

    return apply_epilogue(y, bias, False).to(x.dtype)


def _matmul_f32(x: torch.Tensor, p: "PasmParams", impl: str, bias, relu: bool,
                mesh=None, whole: Optional[tuple] = None) -> torch.Tensor:
    """:func:`matmul`'s body before the final rounding: the f32 product
    (``whole``: the unsharded call's ``(rows, N)`` for a rank's block)."""
    if p.kind == "dense" or impl in ("dense", "dequant"):
        from repro_torch.kernels.ref import apply_epilogue

        # the weight in x's dtype, every product exact in f32 and the sum
        # taken in f32 (the JAX dot's preferred_element_type), for bf16 too
        y = widened_matmul(x, p.dense_matrix(x.dtype))
        return apply_epilogue(y, bias, relu)
    from repro_torch.kernels import ops as _kops

    t = p.gemm_tensor()
    if p.pad_k:
        x = F.pad(x, (0, p.pad_k))
    if impl == "pas_kernel":
        if p.groups > 1:
            raise ValueError(
                "the PAS formulation is paper-faithful single-dictionary; "
                "grouped codebooks need impl='kernel' or 'dequant'"
            )
        return _kops.pas_matmul(x, t, bias=bias, relu=relu, mesh=mesh, whole=whole)
    return _kops.pasm_matmul(x, t, bias=bias, relu=relu, mesh=mesh, whole=whole)


def _held(p: "PasmParams") -> tuple:
    """The ``(K, N)`` rows and columns a leaf's arrays hold (a packed byte
    row is two K rows, the §3 pad row included)."""
    a = p.w if p.kind == "dense" else p.idx
    return int(a.shape[-2]) * (2 if p.packed else 1), int(a.shape[-1])


def held_block(w: Weight, mesh, axis: str = "model") -> tuple:
    """A placed leaf as the operand this rank computes with: ``(params,
    k_split)``, the params' ``shape`` set to the held ``(K, N)`` block
    (a held §3 pad row is an ordinary row: its activation column is zero)
    and ``k_split`` whether the held K rows are a block along ``axis``.  A K
    block's grouped dictionaries are cut to its own groups: the placement
    keeps a K split only where the groups divide it
    (:func:`repro_torch.models.sharding.place_params`)."""
    p = as_params(w)
    K, N = p.shape
    kh, nh = _held(p)
    if (kh, nh) == (K, N) and not p.pad_k:  # held whole: the leaf as it is
        return p, False
    k_split = kh < K + p.pad_k
    cb = p.codebook
    if k_split and cb is not None and cb.shape[-2] > 1:
        n = (K + p.pad_k) // kh
        gl = cb.shape[-2] // n
        cb = cb.narrow(-2, mesh.index(axis) * gl, gl)
    return dataclasses.replace(p, codebook=cb, shape=(kh, nh), pad_k=0), k_split


def block_matmul(x: torch.Tensor, w: Weight, *, impl: str, mesh, axis: str = "model",
                 rows: Optional[int] = None) -> tuple:
    """The per-rank body of the tensor-parallel linears: ``x`` times this
    rank's held block of the placed leaf ``w`` (:func:`held_block`), in f32
    and unrounded, with no collective but one: ``x`` given as a K block of
    a leaf held whole is all-gathered over ``axis`` first.  ``x``'s last
    dim is the whole K (the §3 zero column appended here; cut to the
    rank's block for a K block) or the block's own width.  The kernels plan
    from the unsharded call, ``(rows, N)`` (``rows`` default ``x``'s), so an
    N block is bitwise the unsharded call's columns.  Returns ``(y,
    k_split)``: a K block's ``y`` is this rank's partial sum.

    Differentiable: a replicated ``x`` passes ``enter_split`` before an N
    block and before a K block's ``narrow`` (its gradient is summed over
    ``axis`` in the backward), and a K block of ``x`` gathered for a whole
    leaf gets its own block of the gradient back."""
    p = as_params(w)
    K, N = p.shape
    from repro_torch.launch.mesh import enter_split

    pb, k_split = held_block(p, mesh, axis)
    kh = pb.shape[0]
    if p.pad_k and x.shape[-1] == K:
        x = F.pad(x, (0, p.pad_k))
    Kp = K + p.pad_k
    if pb.shape[1] < N:  # an N block: the replicated x enters this rank's columns
        x = enter_split(x, mesh, axis)
    if k_split and x.shape[-1] == Kp:
        x = enter_split(x, mesh, axis).narrow(-1, mesh.index(axis) * kh, kh)
    elif not k_split and x.shape[-1] != Kp and x.shape[-1] * mesh.size(axis) == Kp:
        from repro_torch.launch.mesh import all_gather

        x = all_gather(x, mesh, axis, dim=-1)
    if x.shape[-1] != kh:
        raise ValueError(f"x's {x.shape[-1]} columns match neither K = {K} nor the "
                         f"held block's {kh} rows")
    whole = (x.numel() // max(kh, 1) if rows is None else rows, N)
    return _matmul_f32(x, pb, impl, None, False, whole=whole), k_split


def embed_lookup(w: Weight, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding-table row gather for any weight leaf.

    A quantized table gathers its uint8 index rows and dereferences the
    dictionary, so no dense ``(V, D)`` matrix is made.  Single-dictionary
    tables only (``quantize_params`` quantizes embeddings with ``G == 1``).
    """
    p = as_params(w)
    if p.kind == "dense":
        return p.w[tokens]
    idx = _pasm.unpack_int4(p.idx) if p.packed else p.idx
    rows = idx[tokens]
    return p.codebook[0][rows.long()]


def dense_weight(w: Weight, dtype=None) -> torch.Tensor:
    """The logical dense ``(…, K, N)`` matrix of any weight leaf.

    The tied-LM-head path: the kernels compute ``x @ W``, not ``x @ Wᵀ``, so
    a tied head dequantizes once and transposes at the call site.
    """
    return as_params(w).dense_matrix(dtype)


def dense_stack(w: Weight, dtype) -> torch.Tensor:
    """Stacked expert weights ``(E, K, N)`` → dense ``dtype``, for the MoE
    einsum path.  Under a mesh the held arrays are this rank's expert block
    (:func:`repro_torch.models.sharding.place_params`: E over ``model``, the
    FFN dim over ``data``), and that block is what comes back."""
    return as_params(w).dense_matrix(dtype)
