"""K1 (``mma``) in the train steps of the traced part of the window against
its roofline: the bounds of the weight-shared products each step launched
(the program's K1 launch counter: the forward's seven a layer and the head,
a recompute's seven a layer again, each over every token; bf16 x, int4
indices, f32 output, each once), over K1's device time by kernel name, in
%."""
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
    M = run.mix["rows"] * run.mix["seq"]
    one = lm_k1_launches(run.cfg, M, M)
    b = [bound_ms(matmul_flops(*s), k1_bytes(*s, x_bytes=2, idx_bits=4), bf16=True).ms
         for s in one]
    layer, head = sum(b[:-1]) / run.cfg["n_layers"], b[-1]  # 7 products a layer, the head
    bound = 0.0
    for *_, a in run.spans.within("train_step", p["host_t0"], p["host_t1"]):
        bound += head + layer * (a["k1"] - 1) / 7
    return 100.0 * bound * 1e-3 / dev
