"""K1 (``stream`` and ``mma``) against its roofline in the traced part of
the window: the bounds of every weight-shared product of the traced model
calls (a prefill's padded bucket of rows, a decode's slots; bf16 x, int4
indices, f32 output, each once), over K1's device time by kernel name
(both routes and their split-K sum), in %."""
import re

from portbench.yardstick import bound_ms, k1_bytes, lm_k1_launches, matmul_flops

K1 = re.compile(r"^(void )?(k1b::)?(stream_kernel|mma_kernel|splitk_reduce)\b")


def read(run):
    p = run.profile
    if p is None:
        return None
    dev = sum(s for n, s in p["kernel_s"].items() if K1.match(n))
    if not dev:
        return None
    bound = 0.0
    for kind, head in (("prefill", 1), ("decode", None)):
        for *_, a in run.spans.within(kind, p["host_t0"], p["host_t1"]):
            for M, K, N in lm_k1_launches(run.cfg, a["rows"], head or a["rows"]):
                bound += bound_ms(matmul_flops(M, K, N),
                                  k1_bytes(M, K, N, x_bytes=2, idx_bits=4), bf16=True).ms
    return 100.0 * bound * 1e-3 / dev
