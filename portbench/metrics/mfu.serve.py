"""The model's operations for the real tokens of the window (each prefill's
real prompt, each live slot's decoded token at its context; padding and
empty slots left out), over the window's seconds, as a share of the H100's
bf16 peak, in %."""
from portbench.yardstick import HW, lm_decode_flops, lm_prefill_flops


def read(run):
    cfg = run.cfg
    f = sum(lm_prefill_flops(cfg, a["n"]) for *_, a in run.spans.within("prefill", run.t0, run.t1))
    f += sum(lm_decode_flops(cfg, c) for *_, a in run.spans.within("decode", run.t0, run.t1)
             for c in a["ctx"])
    return 100.0 * f / (run.window_s * HW().bf16_flops)
