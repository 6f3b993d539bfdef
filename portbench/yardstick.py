"""The benchmark's arithmetic: peaks, bounds, percentiles, and the operations
and bytes of each model and kernel, from shapes alone.

Frozen copies of the program's sound pieces (``repro_torch/roofline.py``:
``HW``, ``bound_ms``; ``serve/metrics.py``: ``percentile``;
``kernels/ops.py``: ``matmul_flops``), kept here so that a change to the
program cannot move the yardstick.  Bytes are the function's: each input
read once and each output written once, no plan scratch.
"""
from __future__ import annotations

import math
from typing import NamedTuple

__all__ = ["HW", "Bound", "bound_ms", "percentile", "matmul_flops", "k1_bytes",
           "cnn_stages", "cnn_flops_per_image", "lm_linear_params", "lm_prefill_flops",
           "lm_decode_flops", "lm_k1_launches", "lm_train_flops"]


class HW(NamedTuple):
    """One H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W)."""

    bf16_flops: float = 989e12  # tensor cores; fp16 the same
    f32_flops: float = 67e12  # outside the tensor cores
    hbm_bw: float = 3.35e12  # bytes/s, HBM3
    hbm_bytes: float = 80e9


class Bound(NamedTuple):
    """``ms`` the larger of ``ops_ms`` and ``bytes_ms``; ``by`` which."""

    ms: float
    by: str
    ops_ms: float
    bytes_ms: float


def bound_ms(flops: float, nbytes: float, bf16: bool, hw: HW = HW()) -> Bound:
    """The least time the card could take for ``flops`` operations (on the
    tensor cores when ``bf16``, else at the f32 rate) and ``nbytes`` bytes."""
    ops_ms = flops / (hw.bf16_flops if bf16 else hw.f32_flops) * 1e3
    bytes_ms = nbytes / hw.hbm_bw * 1e3
    return Bound(max(ops_ms, bytes_ms), "ops" if ops_ms >= bytes_ms else "bytes",
                 ops_ms, bytes_ms)


def percentile(xs, q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) over every value, ``inf``
    included (a miss); nan on empty input."""
    xs = sorted(x for x in xs if not math.isnan(x))
    if not xs:
        return math.nan
    rank = max(0, min(len(xs) - 1, math.ceil(q / 100.0 * len(xs)) - 1))
    return xs[rank]


def matmul_flops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def k1_bytes(M: int, K: int, N: int, *, x_bytes: int, idx_bits: int, groups: int = 1,
             bins: int = 16, out_rows: int = -1, bias: bool = False) -> int:
    """K1's function: ``x (M, K)`` read, the ``(K, N)`` indices at
    ``idx_bits`` and the f32 dictionaries read, the f32 output (``out_rows``
    rows: a fused pool writes fewer) written."""
    out_rows = M if out_rows < 0 else out_rows
    return (M * K * x_bytes + K * N * idx_bits // 8 + groups * bins * 4
            + out_rows * N * 4 + (N * 4 if bias else 0))


# ---------------------------------------------------------------------------
# the CNN: conv stages as K1 GEMMs over im2col patches
# ---------------------------------------------------------------------------


def _out(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "valid":
        return (size - k) // stride + 1
    return (size - 2 * (k // 2) + stride - 1) // stride  # valid_centred


def cnn_stages(cfg: dict) -> list:
    """Per conv stage of one image: ``(rows, K, N, pooled_rows)``: the
    output positions, the patch length, the output channels and the
    positions after the pool."""
    c, h, w = cfg["in_chw"]
    out = []
    for (c_out, k, stride), pool in zip(cfg["layers"], cfg["pools"]):
        h, w = _out(h, k, stride, cfg["padding"]), _out(w, k, stride, cfg["padding"])
        rows = h * w
        if pool > 1:
            h, w = h // pool, w // pool
        out.append((rows, c * k * k, c_out, h * w))
        c = c_out
    return out


def cnn_flops_per_image(cfg: dict) -> int:
    """The model's operations for one image: every conv stage and the head."""
    conv = sum(matmul_flops(rows, K, N) for rows, K, N, _ in cnn_stages(cfg))
    return conv + matmul_flops(1, cfg["features"], cfg["classes"])


# ---------------------------------------------------------------------------
# the dense transformer LM
# ---------------------------------------------------------------------------


def _lm_mats(cfg: dict) -> list:
    """One layer's weight-shared matrices as ``(K, N)``."""
    D, F, hd = cfg["d_model"], cfg["d_ff"], cfg["head_dim"]
    q, kv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    return [(D, q), (D, kv), (D, kv), (q, D), (D, F), (D, F), (F, D)]


def lm_linear_params(cfg: dict) -> int:
    """Weights of every layer's linears (the head apart)."""
    return cfg["n_layers"] * sum(K * N for K, N in _lm_mats(cfg))


def _attn_flops(cfg: dict, q_pos_keys: int) -> int:
    """Q·Kᵀ and P·V over ``q_pos_keys`` (query, key) pairs, every layer."""
    return cfg["n_layers"] * 2 * 2 * cfg["n_heads"] * cfg["head_dim"] * q_pos_keys


def lm_prefill_flops(cfg: dict, n: int) -> int:
    """A prompt of ``n`` real tokens: every linear for each token, causal
    attention, and the head at the last position only (what serving needs)."""
    return (2 * n * lm_linear_params(cfg) + _attn_flops(cfg, n * (n + 1) // 2)
            + matmul_flops(1, cfg["d_model"], cfg["vocab"]))


def lm_decode_flops(cfg: dict, ctx: int) -> int:
    """One generated token whose query sees ``ctx`` keys (itself included)."""
    return (2 * lm_linear_params(cfg) + _attn_flops(cfg, ctx)
            + matmul_flops(1, cfg["d_model"], cfg["vocab"]))


def lm_k1_launches(cfg: dict, rows: int, head_rows: int) -> list:
    """The weight-shared products of one model call as ``(M, K, N)``: every
    layer's linears over ``rows`` rows (a prefill's padded bucket, or the
    decode batch's slots), then the head over ``head_rows``."""
    out = [(rows, K, N) for _ in range(cfg["n_layers"]) for K, N in _lm_mats(cfg)]
    return out + [(head_rows, cfg["d_model"], cfg["vocab"])]


def lm_train_flops(cfg: dict, rows: int, seq: int) -> int:
    """One training step's model operations: three times the forward's
    (forward, and the backward's two products a weight) over every token,
    every linear and the head, and causal attention; a recompute not
    counted."""
    tokens = rows * seq
    linear = lm_linear_params(cfg) + cfg["d_model"] * cfg["vocab"]
    return 3 * (2 * tokens * linear + rows * _attn_flops(cfg, seq * (seq + 1) // 2))
