"""K1 (``simt``) against its roofline in the traced part of the window: the
bounds of every conv stage's GEMM the traced forwards ran (from shapes: f32
patches, uint8 indices and the pooled f32 output, each once), over K1's
device time by kernel name (the GEMM and its split-K sum), in %."""
import re

from portbench.yardstick import bound_ms, k1_bytes, matmul_flops, cnn_stages

K1 = re.compile(r"^(void )?(pasm::)?(pasm_matmul_kernel|split_sum)\b")


def read(run):
    p = run.profile
    if p is None:
        return None
    dev = sum(s for n, s in p["kernel_s"].items() if K1.match(n))
    if not dev:
        return None
    bound = 0.0
    for *_, a in run.spans.within("classify", p["host_t0"], p["host_t1"]):
        for rows, K, N, pooled in cnn_stages(run.cfg):
            M = a["n"] * rows
            bound += bound_ms(matmul_flops(M, K, N),
                              k1_bytes(M, K, N, x_bytes=4, idx_bits=8,
                                       out_rows=a["n"] * pooled, bias=True),
                              bf16=False).ms
    return 100.0 * bound * 1e-3 / dev
