"""The model's operations for the steps of the window (three times the
forward's: every linear and the head over every token, and causal
attention; from the configuration's shapes, recompute not counted) over
the window's seconds, as a share of the H100's bf16 peak, in %."""
from portbench.yardstick import HW, lm_train_flops


def read(run):
    f = run.counters["steps"] * lm_train_flops(run.cfg, run.mix["rows"], run.mix["seq"])
    return 100.0 * f / (run.window_s * HW().bf16_flops)
