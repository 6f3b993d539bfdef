"""Analytical hardware cost model reproducing the paper's evaluation.

Port of ``repro.core.hwmodel`` (pure Python; every figure equals the JAX
package's).  The paper evaluates PASM by synthesizing Verilog/SystemC to a
45 nm ASIC (Cadence Genus) and a Zynq FPGA (Vivado), reporting
NAND2-normalized gate counts, power, and latency.  This analytical model is
the reproduction vehicle for those claims (DESIGN.md §2):

1. **Structural unit model** — paper Table 1's complexity model with explicit
   NAND2-equivalent constants: adder O(W), array multiplier O(W²), register
   O(W), register-file port O(W·B).  Two constants the paper does not report
   (mux cost per bit·bin, HLS pipeline-register depth) are solved in closed
   form against the paper's §2.4 anchor point (W=32, B=16 standalone:
   sequential −35 %, logic −68 %) — everything else is textbook.
2. **Accelerator-level calibrated model** — the in-CNN accelerator results
   (Figs 15–22) depend on synthesis timing pressure at 1 GHz that a structural
   model cannot see; the paper's own explanation is that the unrolled B-bin
   register network blows up with B.  The paper's observed log-linear law
   ``ratio(B) = a + b·log2(B)`` is fitted per metric from two quoted anchors
   and checked to *predict* the third (the B=16 crossover where "PASM no
   longer offers a good return").
3. **Cycle/latency model** — §2.2/§4: MAC ≈ N cycles, PASM ≈ N + P·B.

4. **HBM traffic** — the plan-free bytes one conv or linear layer must move
   (:func:`conv_hbm_traffic`, :func:`dense_hbm_traffic`,
   :func:`dense_weight_stream_bytes`): each input read once, each output
   written once.  The dense terms and the explicit-im2col conv term equal
   the JAX package's.  The implicit conv term follows the port's dataflow:
   K2/K4 read the unpadded image once and mask the padding, with no VMEM
   slab schedule, so it has no budget argument.  The tile-plan aware
   counterparts are ``repro_torch.kernels.ops.pasm_hbm_bytes`` and
   ``conv_hbm_bytes``.

All paper-quoted numbers live in :data:`PAPER_CLAIMS`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

__all__ = [
    "GateConstants",
    "UnitGates",
    "mac_unit",
    "weight_shared_mac_unit",
    "pas_unit",
    "accel_16mac",
    "accel_16pas4mac",
    "gate_ratio",
    "power_model",
    "accel_ratio_asic",
    "accel_ratio_fpga",
    "conv_latency_cycles",
    "conv_latency_ratio",
    "conv_hbm_traffic",
    "dense_hbm_traffic",
    "dense_weight_stream_bytes",
    "im2col_inflation",
    "fpga_resources",
    "PAPER_CLAIMS",
]

# ---------------------------------------------------------------------------
# paper-quoted numbers (anchor + validation data)
# ---------------------------------------------------------------------------

PAPER_CLAIMS: Dict[str, float] = {
    # §2.4 standalone 16-MAC vs 16-PAS-4-MAC, W=32, B=16 (fractions REMAINING)
    "standalone.seq_ratio": 1 - 0.35,
    "standalone.inv_ratio": 1 - 0.78,
    "standalone.buf_ratio": 1 - 0.61,
    "standalone.logic_ratio": 1 - 0.68,
    "standalone.total_ratio": 1 - 0.66,
    "standalone.leak_power_ratio": 1 - 0.60,
    "standalone.dyn_power_ratio": 1 - 0.70,
    "standalone.total_power_ratio": 1 - 0.70,
    # §5.1 ASIC accelerator, 32-bit kernels (PASM vs weight-shared)
    "asic.gates_ratio.b4": 1 - 0.478,
    "asic.power_ratio.b4": 1 - 0.532,
    "asic.gates_ratio.b8": 1 - 0.081,
    "asic.power_ratio.b8": 1 - 0.152,
    # 8-bit kernels, 4 bins
    "asic.gates_ratio.w8b4": 1 - 0.198,
    "asic.power_ratio.w8b4": 1 - 0.313,
    # §5.2 FPGA accelerator, 32-bit kernels
    "fpga.dsp_ratio": 1 - 0.99,
    "fpga.bram_ratio": 1 - 0.28,
    "fpga.power_ratio.b4": 1 - 0.64,
    "fpga.power_ratio.b8": 1 - 0.416,
    "fpga.power_ratio.b16": 1 - 0.18,
    # §5.1 latency (PASM vs weight-shared accelerator, fraction INCREASE)
    "latency.increase.b4": 0.085,
    "latency.increase.b16": 0.1275,
    # §2.2 worked cycle example
    "cycles.example": 1088,
}

# paper's accelerator conv dimensions (§4): 5×5 image, 15 ch, 3×3 kernel, M=2
PAPER_CONV = dict(IH=5, IW=5, C=15, KY=3, KX=3, M=2, stride=1)


# ---------------------------------------------------------------------------
# 1. structural unit model (Table 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GateConstants:
    """NAND2-equivalent gate constants.  Textbook values unless noted."""

    c_add: float = 6.0      # full adder ≈ 6 NAND2 per bit (ripple)
    c_mul: float = 30.0     # timing-driven multiplier, NAND2 per bit²  [calibrated]
    c_reg: float = 6.0      # DFF ≈ 6 NAND2 per bit
    c_port: float = 2.0     # regfile port mux per bit·bin  [calibrated]
    pipe_stages: float = 13.5  # HLS-inserted pipeline regs  [calibrated]
    # Calibration (closed-form against the paper's §2.4 W=32/B=16 anchor —
    # checked by tests/test_hwmodel.py): c_mul=30 reflects the Wallace/Booth
    # multiplier the synthesizer instantiates under a timing constraint (a
    # plain array multiplier is ~6/bit²); pipe_stages=13.5 absorbs the HLS
    # pipeline registers the paper itself reports as a 97 % flip-flop
    # increase (§4); c_port=2.0 is a B:1 mux tree per bit (~2 NAND2/bit·bin).


@dataclasses.dataclass(frozen=True)
class UnitGates:
    """Gate counts by category (NAND2-normalized), mirroring Genus categories."""

    mult: float
    logic_rest: float  # adders, muxes, ports — combinational minus multiplier
    seq: float         # registers / flip-flops

    @property
    def logic(self) -> float:
        return self.mult + self.logic_rest

    # Inverters sit overwhelmingly in the multiplier reduction tree; buffers
    # drive the clock tree (∝ seq) and long combinational nets (∝ logic).
    # The seq/logic split for buffers is solved from the paper anchor
    # (see calibrate_buffers()).
    def inverters(self) -> float:
        return 0.30 * self.mult + 0.02 * self.logic_rest

    def buffers(self, seq_frac: float = 0.5) -> float:
        return 0.15 * (seq_frac * self.seq + (1 - seq_frac) * self.logic)

    def total(self) -> float:
        return self.logic + self.seq + self.inverters() + self.buffers()

    def __add__(self, o: "UnitGates") -> "UnitGates":
        return UnitGates(self.mult + o.mult, self.logic_rest + o.logic_rest, self.seq + o.seq)

    def __mul__(self, k: float) -> "UnitGates":
        return UnitGates(self.mult * k, self.logic_rest * k, self.seq * k)

    __rmul__ = __mul__


def mac_unit(W: int, c: GateConstants = GateConstants()) -> UnitGates:
    """Simple MAC (paper Fig 2): multiplier + adder + 2W-bit accumulator."""
    return UnitGates(
        mult=c.c_mul * W * W,
        logic_rest=c.c_add * W,
        seq=c.c_reg * 2 * W * (1 + c.pipe_stages),  # acc + pipeline regs
    )


def weight_shared_mac_unit(W: int, B: int, c: GateConstants = GateConstants()) -> UnitGates:
    """Weight-shared MAC (Fig 3): MAC + B-entry weight regfile + 1 read port."""
    base = mac_unit(W, c)
    return UnitGates(
        mult=base.mult,
        logic_rest=base.logic_rest + c.c_port * W * B,
        seq=base.seq + c.c_reg * W * B,
    )


def pas_unit(W: int, B: int, c: GateConstants = GateConstants()) -> UnitGates:
    """PAS (Fig 5/Table 1): adder + B accumulators + read AND write ports."""
    return UnitGates(
        mult=0.0,
        logic_rest=c.c_add * W + 2 * c.c_port * W * B,
        seq=c.c_reg * W * B + c.c_reg * 2 * W,  # bins + input pipe reg
    )


def accel_16mac(W: int, B: int, c: GateConstants = GateConstants()) -> UnitGates:
    """The paper's standalone baseline: 16 weight-shared MACs."""
    return 16 * weight_shared_mac_unit(W, B, c)


def accel_16pas4mac(W: int, B: int, c: GateConstants = GateConstants()) -> UnitGates:
    """The paper's PASM unit: 16 PAS + 4 shared post-pass (weight-shared) MACs."""
    return 16 * pas_unit(W, B, c) + 4 * weight_shared_mac_unit(W, B, c)


def gate_ratio(W: int, B: int, c: GateConstants = GateConstants()) -> Dict[str, float]:
    """PASM/MAC gate-count ratios by category (paper Figs 7 & 9)."""
    m = accel_16mac(W, B, c)
    p = accel_16pas4mac(W, B, c)
    return {
        "seq": p.seq / m.seq,
        "logic": p.logic / m.logic,
        "inv": p.inverters() / m.inverters(),
        "buf": p.buffers() / m.buffers(),
        "total": p.total() / m.total(),
    }


# power: dynamic ∝ Σ activity·gates (multiplier toggles hardest); leakage ∝
# gates with sequential cells weighted (larger cells).  Activities are
# standard CMOS estimates; they land within a few % of the paper's anchors
# (checked in tests/test_hwmodel.py; the port equals it,
# tests/test_torch_hwmodel.py).
_ACT = dict(mult=0.40, logic_rest=0.15, seq=0.20, inv=0.35, buf=0.30)
_LEAK = dict(mult=1.0, logic_rest=1.0, seq=1.6, inv=0.6, buf=0.8)


def _power_terms(u: UnitGates) -> Dict[str, float]:
    parts = dict(
        mult=u.mult, logic_rest=u.logic_rest, seq=u.seq, inv=u.inverters(), buf=u.buffers()
    )
    dyn = sum(_ACT[k] * v for k, v in parts.items())
    leak = sum(_LEAK[k] * v for k, v in parts.items())
    return {"dynamic": dyn, "leakage": leak, "total": dyn + leak * 0.12}


def power_model(W: int, B: int, c: GateConstants = GateConstants()) -> Dict[str, float]:
    """PASM/MAC power ratios (paper Figs 8 & 10)."""
    pm = _power_terms(accel_16mac(W, B, c))
    pp = _power_terms(accel_16pas4mac(W, B, c))
    return {k: pp[k] / pm[k] for k in pm}


# ---------------------------------------------------------------------------
# 2. accelerator-level calibrated model (Figs 15-22)
# ---------------------------------------------------------------------------


def _loglin(b4: float, b8: float, B: int) -> float:
    """Fit ratio(B) = a + s·log2(B) through the two paper anchors, evaluate."""
    s = b8 - b4  # per-doubling slope (anchors at log2 = 2 and 3)
    a = b4 - 2 * s
    return a + s * math.log2(B)


def accel_ratio_asic(B: int, W: int = 32) -> Dict[str, float]:
    """PASM/weight-shared in-accelerator ratios, 45 nm ASIC @ 1 GHz.

    Calibrated from the paper's B=4 and B=8 anchors (32-bit kernels); the
    model's B=16 prediction > 1 reproduces the paper's reported crossover.
    For W=8 only the B=4 anchor exists; the same slope is reused (the paper's
    own qualitative statement is that the crossover comes *earlier* at W=8).
    """
    if W == 32:
        g = _loglin(PAPER_CLAIMS["asic.gates_ratio.b4"], PAPER_CLAIMS["asic.gates_ratio.b8"], B)
        p = _loglin(PAPER_CLAIMS["asic.power_ratio.b4"], PAPER_CLAIMS["asic.power_ratio.b8"], B)
    elif W == 8:
        slope_g = PAPER_CLAIMS["asic.gates_ratio.b8"] - PAPER_CLAIMS["asic.gates_ratio.b4"]
        slope_p = PAPER_CLAIMS["asic.power_ratio.b8"] - PAPER_CLAIMS["asic.power_ratio.b4"]
        g = PAPER_CLAIMS["asic.gates_ratio.w8b4"] + slope_g * (math.log2(B) - 2)
        p = PAPER_CLAIMS["asic.power_ratio.w8b4"] + slope_p * (math.log2(B) - 2)
    else:
        raise ValueError(f"calibration only for W in (8, 32), got {W}")
    return {"gates": g, "power": p}


def accel_ratio_fpga(B: int) -> Dict[str, float]:
    """PASM/weight-shared in-accelerator ratios, Zynq XC7Z045 @ 200 MHz."""
    p4, p8 = PAPER_CLAIMS["fpga.power_ratio.b4"], PAPER_CLAIMS["fpga.power_ratio.b8"]
    return {
        "dsp": PAPER_CLAIMS["fpga.dsp_ratio"],
        "bram": PAPER_CLAIMS["fpga.bram_ratio"],
        "power": _loglin(p4, p8, B),
    }


def fpga_resources(B: int, W: int = 32, pasm: bool = True) -> Dict[str, int]:
    """Absolute FPGA resource model (§5.2): WS accel = 405 DSPs, PASM = 3."""
    if pasm:
        return {"dsp": 3, "bram_rel": 72}  # 28 % fewer BRAMs (normalized 100)
    return {"dsp": 405, "bram_rel": 100}


# ---------------------------------------------------------------------------
# 3. cycle / latency model
# ---------------------------------------------------------------------------


def conv_latency_cycles(
    *, IH: int, IW: int, C: int, KY: int, KX: int, M: int, stride: int = 1,
    bins: int = 0, postpass_mults: int = 1,
) -> int:
    """Pipelined conv-layer latency in cycles (paper Fig 13 structure).

    ``bins=0`` → weight-shared/simple MAC accelerator: each output pixel×M
    costs N = C·KY·KX pipelined MACs.  ``bins=B`` → PASM: adds the post-pass
    multiply of B bins through ``postpass_mults`` multipliers (ALLOCATION
    limit=1 in the paper) plus fixed drain/control overhead per output.
    """
    OH = (IH - 2 * (KY // 2) + stride - 1) // stride
    OW = (IW - 2 * (KX // 2) + stride - 1) // stride
    n = C * KY * KX
    per_out = n
    if bins:
        # calibrated post-pass overhead: fixed control/drain (≈10 cycles) +
        # B multiplies through the shared multiplier.
        per_out = n + int(round(9.6 + 0.475 * bins / postpass_mults))
    return OH * OW * M * per_out


def conv_latency_ratio(bins: int, conv: dict = PAPER_CONV) -> float:
    """PASM/weight-shared conv latency ratio (paper Fig 14: +8.5 %…+12.75 %)."""
    base = conv_latency_cycles(**conv, bins=0)
    pasm = conv_latency_cycles(**conv, bins=bins)
    return pasm / base


# ---------------------------------------------------------------------------
# 4. conv HBM traffic (im2col dataflow: explicit vs implicit)
# ---------------------------------------------------------------------------


def im2col_inflation(KY: int, KX: int, stride: int = 1) -> float:
    """Activation-byte inflation of a materialized patch matrix vs the image.

    Each input pixel lands in up to ``KY·KX/stride²`` patches (≈7.6× for
    AlexNet conv1: 11·11/4² = 7.5625) — the factor implicit-GEMM removes.
    """
    return KY * KX / stride ** 2


def conv_hbm_traffic(
    *, IH: int, IW: int, C: int, KY: int, KX: int, M: int, stride: int = 1,
    batch: int = 1, bins: int = 16, pad: tuple = (0, 0, 0, 0),
    act_bytes: int = 4, packed: bool = True, implicit: bool = True,
    pool: int = 1, dense: bool = False,
) -> int:
    """Logical-shape HBM bytes of one conv layer on the PASM GEMM.

    Weights stream as ``log2(B)``-bit indices (int4-``packed`` halves them)
    plus a ``bins``-entry f32 dictionary on either path, and the f32 output
    (pooled when ``pool > 1``: the fused conv/ReLU/max-pool stage) is
    stored once, so the paths differ only in the activation term:

    * ``implicit=False`` (explicit im2col): the ``(B·P, K)`` patch matrix is
      written by the front-end and read back by K1/K3 — ``2·B·P·K``
      elements, as in the JAX package;
    * ``implicit=True``: K2/K4 gather the patches in the kernel from the
      **unpadded** image, masking the padding, so the image is read once:
      ``B·C·IH·IW`` elements.  The JAX package's TPU kernels read the padded
      image in VMEM slabs instead; the two agree where ``pad`` is 0 and the
      image fits JAX's slab budget.

    ``dense=True`` models the einsum reference: a dense f32 weight stream
    (``K·M·4`` B, no indices, no dictionary).
    """
    plh, phh, plw, phw = pad
    hp, wp = IH + plh + phh, IW + plw + phw
    OH = (hp - KY) // stride + 1
    OW = (wp - KX) // stride + 1
    K = C * KY * KX
    OHp, OWp = OH // pool, OW // pool
    P = OHp * OWp * pool * pool  # GEMM rows; == OH·OW when pool == 1
    if dense:
        idx_bytes, cb_bytes = K * M * 4, 0  # dense f32 weights, no dictionary
    else:
        idx_bytes = K * M // 2 if packed else K * M
        cb_bytes = bins * 4
    out_bytes = batch * OHp * OWp * M * 4  # f32 store (pooled when pool > 1)
    if implicit:
        x_bytes = batch * C * IH * IW * act_bytes
    else:
        x_bytes = 2 * batch * P * K * act_bytes  # im2col store + kernel stream
    return x_bytes + idx_bytes + cb_bytes + out_bytes


# ---------------------------------------------------------------------------
# 5. dense-layer HBM traffic (the weight-stream argument beyond conv)
# ---------------------------------------------------------------------------


def dense_weight_stream_bytes(
    K: int, N: int, *, bins: int = 16, groups: int = 1,
    packed: bool = True, dense: bool = False, dense_dtype_bytes: int = 2,
) -> int:
    """HBM bytes a ``(K, N)`` weight matrix streams per GEMM pass.

    A dense stream costs ``K·N·dense_dtype_bytes``; the PASM stream is
    ``log2(B)``-bit indices (int4-``packed`` halves uint8) plus the
    ``(G, B)`` f32 dictionary — the accounting ``PasmParams.nbytes_weights``
    reports for a stored tree, in closed form.
    """
    if dense:
        return K * N * dense_dtype_bytes
    return (K * N // 2 if packed else K * N) + groups * bins * 4


def dense_hbm_traffic(
    *, T: int, K: int, N: int, bins: int = 16, groups: int = 1,
    act_bytes: int = 2, packed: bool = True, dense: bool = False,
) -> int:
    """Logical-shape HBM bytes of one dense (linear) layer on the PASM GEMM.

    ``T`` tokens of ``(T, K)`` activations stream in, the weight matrix
    streams per :func:`dense_weight_stream_bytes`, and the ``(T, N)`` result
    stores back at ``act_bytes`` — the decode-time regime where the weight
    stream dominates and weight sharing pays.
    """
    w = dense_weight_stream_bytes(
        K, N, bins=bins, groups=groups, packed=packed, dense=dense,
        dense_dtype_bytes=2,
    )
    return T * K * act_bytes + w + T * N * act_bytes
