"""The attention heads a rank runs under a mesh, for the sharding tests.

No JAX here: the spawned ranks of the sharding tests import it.
"""
import contextlib

from repro_torch.nn import attention as A

# (q heads, KV heads, ranks along model) -> each model rank's (first q head,
# q heads, KV heads its attention reads), as GSPMD splits q's heads into
# gcd(q heads, model) blocks: the hybrid smoke's one KV head, a block that
# straddles a KV group (heads 0-2 read KV 0, 0, 1; 3-5 read 1, 2, 2: one KV
# head a q head), the same over 4 ranks (two ranks a block), qwen3's smoke
# over 4 (one head a rank, half a KV group)
HEADS = {
    (2, 1, 2): [(0, 1, 1), (1, 1, 1)],
    (6, 3, 2): [(0, 3, 3), (3, 3, 3)],
    (6, 3, 4): [(0, 3, 3), (0, 3, 3), (3, 3, 3), (3, 3, 3)],
    (4, 2, 4): [(0, 1, 1), (1, 1, 1), (2, 1, 1), (3, 1, 1)],
}


def want(n_heads: int, n_kv: int, tp: int, rank: int) -> tuple:
    """``(q0, nq, kv)`` for one model rank: every head on one rank of
    ``model``, else :data:`HEADS`."""
    return (0, n_heads, n_kv) if tp == 1 else HEADS[n_heads, n_kv, tp][rank]


@contextlib.contextmanager
def attended():
    """The ``(q heads, KV heads)`` of every ``gqa_attention`` call made
    inside, in call order."""
    seen, inner = [], A.gqa_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape[2], k.shape[2]))
        return inner(q, k, v, **kw)

    A.gqa_attention = spy
    try:
        yield seen
    finally:
        A.gqa_attention = inner
