"""Three-term roofline of one step on the NVIDIA H100, from what the port counts.

    compute term    = FLOPs per device / peak FLOP/s
    memory term     = bytes per device / HBM rate
    collective term = ring-weighted collective bytes per device / link rate

Port of ``repro.roofline``.  The JAX package reads its terms from a compiled
XLA executable: ``cost_analysis()`` and the optimized HLO text.  The port
has no compiled program, so its inputs are its own:

* :class:`StepCounter`, a ``TorchDispatchMode`` around the step: its FLOPs
  by ``torch.utils.flop_counter``'s formulas (what ``FlopCounterMode``
  counts), the bytes every aten op reads and writes (views move none), and
  the peak of the live tensor bytes the step allocates.  It runs on real
  or ``meta`` tensors alike: the dry run counts a step it never computes.
  :meth:`StepCounter.op_bytes_by_kind` and :meth:`StepCounter.biggest_tensors`
  are the counterparts of ``hlo_bytes_by_op`` and ``hlo_biggest_tensors``;
* :func:`collective_stats` over ``launch/mesh.py``'s ``collective_ops``
  (the result bytes of every collective a rank ran, by kind and group
  size), with the HLO parser's ring weights: ``2·(g−1)/g`` for an
  all-reduce, ``(g−1)/g`` for a gather.

The rates are the H100 SXM's (:class:`HW`, NVIDIA's data sheet, dense,
at the 700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
f32 outside them, 3.35 TB/s HBM3, NVLink 450 GB/s each way to the host's
other cards, 80 GB of device memory.  :func:`bound_ms` is the one bound
every kernel row uses: the least time the card could take for a function,
the larger of its operations over the peak of their type and its bytes
over the memory rate.
"""
from __future__ import annotations

import dataclasses
import json
import weakref
from typing import NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["HW", "Bound", "bound_ms", "CollectiveStats", "collective_stats",
           "StepCounter", "RooflineReport", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One H100 SXM's peak rates (dense, no sparsity) and memory."""

    bf16_flops: float = 989e12  # tensor cores; fp16 the same
    f32_flops: float = 67e12  # outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s, HBM3
    link_bw: float = 450e9  # bytes/s each way, NVLink to the other cards
    n_links: int = 1  # NVSwitch: one all-to-all port a card
    hbm_bytes: float = 80e9

    @property
    def peak_flops(self) -> float:
        """The yardstick of ``roofline_fraction``: the bf16 peak."""
        return self.bf16_flops

    def flops_rate(self, dtype: torch.dtype) -> float:
        """The peak for operations on ``dtype`` (bf16 and f16 on the tensor
        cores, anything else at the f32 rate)."""
        return self.bf16_flops if dtype in (torch.bfloat16, torch.float16) else self.f32_flops


class Bound(NamedTuple):
    """A function's roofline bound: ``ms`` the larger of ``ops_ms`` and
    ``bytes_ms``, ``by`` which of the two sets it."""

    ms: float
    by: str
    ops_ms: float
    bytes_ms: float


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype, hw: HW = HW()) -> Bound:
    """The least time the card could take for ``flops`` operations on
    ``dtype`` that must move ``nbytes`` (each input read once, each output
    written once): ``max(flops / peak(dtype), nbytes / hbm_bw)``, in ms."""
    ops_ms = flops / hw.flops_rate(dtype) * 1e3
    bytes_ms = nbytes / hw.hbm_bw * 1e3
    return Bound(max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes",
                 ops_ms, bytes_ms)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())


def collective_stats(ops: dict) -> CollectiveStats:
    """Per-device collective payload bytes from ``launch/mesh.py``'s
    ``collective_ops`` (``{(kind, group size): [result bytes, calls]}``),
    weighted as a ring moves them: an all-reduce ``2·(g−1)/g`` of its
    bytes, an all-gather ``(g−1)/g``."""
    bytes_by_kind: dict = {}
    count_by_kind: dict = {}
    for (kind, g), (nbytes, calls) in ops.items():
        w = (2.0 if kind == "all-reduce" else 1.0) * (g - 1) / g
        bytes_by_kind[kind] = bytes_by_kind.get(kind, 0.0) + nbytes * w
        count_by_kind[kind] = count_by_kind.get(kind, 0) + calls
    return CollectiveStats(bytes_by_kind, count_by_kind)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what a step does, on real or ``meta`` tensors.

    ``flops``: each op's FLOPs by ``torch.utils.flop_counter``'s formulas;
    ``nbytes``: the bytes each op reads (its tensor inputs) and writes (its
    outputs), views and aliases none; an in-place update its sources and
    its destination read and written, a copy or scatter into a destination
    its sources twice (read, then written); ``peak_bytes``: the largest sum of
    live storages the step allocated (those it was handed are not counted:
    add the argument bytes for the step's peak).  Use as a context manager
    around the step."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.nbytes = 0
        self.peak_bytes = 0
        self._live = 0
        self._refs: dict = {}  # storage -> [views alive, bytes]
        self._by_op: dict = {}
        self._biggest: list = []

    def _release(self, key) -> None:
        rec = self._refs[key]
        rec[0] -= 1
        if rec[0] == 0:
            self._live -= rec[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        key = t.untyped_storage()._cdata
        if key not in self._refs:
            if not fresh:
                return  # a view of a tensor the step was handed
            self._refs[key] = [0, t.untyped_storage().nbytes()]
            self._live += self._refs[key][1]
            self.peak_bytes = max(self.peak_bytes, self._live)
        self._refs[key][0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        held = {t.untyped_storage()._cdata for t in ins}
        mutable = func._schema.is_mutable
        # a view (``view``, ``_unsafe_view``, ``detach``, ...) shares an
        # input's storage and moves nothing
        view = not mutable and outs and all(t.untyped_storage()._cdata in held for t in outs)
        for t in outs:
            self._track(t, fresh=t.untyped_storage()._cdata not in held)
        if not view:
            name = str(packet).split(".")[-1]
            if mutable:  # an in-place update
                dst = {t.untyped_storage()._cdata for t in outs}
                src = [t for t in ins if t.untyped_storage()._cdata not in dst]
                d = sum(_nbytes(t) for t in outs)
                if name == "copy_" or "index" in name or "scatter" in name:
                    moved = 2 * sum(_nbytes(t) for t in src)  # sources read, then written
                else:  # elementwise: the destination read and written too
                    moved = sum(_nbytes(t) for t in src) + 2 * d
            else:
                moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.nbytes += moved
            self._by_op[name] = self._by_op.get(name, 0) + moved
            for t in outs:
                self._biggest.append((_nbytes(t), name, tuple(t.shape)))
            if len(self._biggest) > 256:
                self._biggest = sorted(self._biggest, reverse=True)[:64]
        return out

    def op_bytes_by_kind(self, top: int = 15) -> list:
        """Bytes read and written, summed per aten op: a coarse "where do
        the bytes go" (the port's ``hlo_bytes_by_op``)."""
        return sorted(self._by_op.items(), key=lambda kv: -kv[1])[:top]

    def biggest_tensors(self, top: int = 12) -> list:
        """The largest single results ``(bytes, op, shape)`` (the port's
        ``hlo_biggest_tensors``)."""
        return sorted(self._biggest, reverse=True)[:top]


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_flops_frac: float
    n_devices: int
    collectives: dict
    extra: dict
    hw: HW = HW()

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap bound)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute fraction of the roofline bound: the model's FLOPs
        a device at the bf16 peak ÷ the bound-achieving step time."""
        ideal = self.model_flops / self.n_devices / self.hw.peak_flops
        return ideal / max(self.step_time_s, 1e-30)

    @property
    def memory_efficiency(self) -> float:
        """For memory-bound cells (decode): ideal bytes (weights + cache read
        once a step = the argument bytes) ÷ the bytes the step moves."""
        ideal = self.extra.get("argument_bytes_per_device", 0) / self.hw.hbm_bw
        return ideal / max(self.memory_s, 1e-30)


def roofline_terms(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    n_devices: int,
    flops: float,
    nbytes: float,
    collectives: CollectiveStats,
    model_flops: float,
    hw: HW = HW(),
    extra: Optional[dict] = None,
) -> RooflineReport:
    """The three terms of one device's step: ``flops`` at the bf16 peak (the
    LM's matrix products run on bf16 activations), ``nbytes`` at the HBM
    rate, the ring-weighted ``collectives`` at the link rate."""
    compute_s = flops / hw.peak_flops
    memory_s = nbytes / hw.hbm_bw
    collective_s = collectives.total_bytes / (hw.link_bw * hw.n_links)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=float(flops), bytes_per_device=float(nbytes),
        collective_bytes=collectives.total_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_frac=model_flops / n_devices / max(flops, 1.0),
        n_devices=n_devices,
        collectives={"bytes": collectives.bytes_by_kind,
                     "counts": collectives.count_by_kind},
        extra=extra or {}, hw=hw,
    )
