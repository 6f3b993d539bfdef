"""The port's MoE layer (``repro_torch.nn.moe``) against the JAX package's.

The same numpy inputs and weights go through ``repro.nn.moe.moe_ffn`` and
the port's: dropless and capacity dispatch, one and four groups, with and
without shared experts, each activation, f32 and bf16 ``x``, dense
weights and per-expert dictionaries (the JAX ``quantize`` of the stack,
carried across by ``interop``) on ``dequant`` and on ``kernel`` (K1's plain
version here).  The JAX side runs on ``dequant``; one ``pas_kernel`` case
of ``_expert_matmul`` runs the JAX Pallas kernel in interpret mode.

Exact: the chosen experts (``jax.lax.top_k`` of JAX's own routing), the
dropped (token, expert) entries — JAX's are read off its output, which
for each token is one of 2^k sums of its gated expert outputs — and
``moe_drop_frac``.  Within 1e-6: ``moe_load_balance``.  Outputs within
5e-3, the tolerance of the JAX package's own MoE tests; with bf16 ``x``
5e-3 + 2^-7·max|y|: the two frameworks round bf16 elementwise ops at
other places (XLA's logistic is not torch's), so an expert's SiLU output
may differ by an ulp, which its ``w2`` product carries into the output at
the scale of the largest outputs, not of each one.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import port_params

from repro.configs.base import MoEConfig as JMoEConfig
from repro.core import params as jpar
from repro.nn import moe as JM
from repro_torch.configs.base import MoEConfig
from repro_torch.core import params as tpar
from repro_torch.nn import moe as TM

TOL = 5e-3  # tests/test_moe.py's
BF16_TOL = 2.0 ** -7  # of max |y|, with bf16 x (above)
D, FE = 16, 8


def _weights(E, shared, seed=0):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((D, E)) * 0.2,
         "w1": rng.standard_normal((E, D, FE)) * 0.2,
         "w3": rng.standard_normal((E, D, FE)) * 0.2,
         "w2": rng.standard_normal((E, FE, D)) * 0.2}
    if shared:
        p |= {"shared_w1": rng.standard_normal((D, 2 * FE)) * 0.2,
              "shared_w3": rng.standard_normal((D, 2 * FE)) * 0.2,
              "shared_w2": rng.standard_normal((2 * FE, D)) * 0.2}
    return {k: v.astype(np.float32) for k, v in p.items()}


def _quantized(p):
    """Every matrix but the router weight-shared by the JAX package: the
    expert stacks per expert, 16 bins int4 packed, two dictionaries."""
    q = jax.jit(lambda a: jpar.PasmParams.quantize(a, 16, groups=2, iters=4).pack())
    return {k: v if k == "router" else q(jnp.asarray(v)) for k, v in p.items()}


@functools.lru_cache(maxsize=None)
def _both(E, shared, quantized):
    """(JAX tree, port tree) of the same weights."""
    p = _weights(E, shared)
    if quantized:
        p = _quantized(p)
    jp = {k: (v if isinstance(v, jpar.PasmParams) else jnp.asarray(v)) for k, v in p.items()}
    return jp, port_params(jp)


def _cfgs(E, k, cf=1.0):
    kw = dict(n_experts=E, top_k=k, d_expert=FE, n_shared=2, d_shared=FE,
              capacity_factor=cf)
    return JMoEConfig(**kw), MoEConfig(**kw)


def _jax_kept(y, x, jp, top_w, top_i, act):
    """JAX's kept (token, j) entries, read off its f32 output: the routed
    part of token t is ``Σ_j keep_tj·g_tj·f_e(x_t)`` for one of 2^k keep
    patterns; the pattern whose sum is nearest (and far nearer than any
    other) is the one JAX kept."""
    x = np.asarray(x, np.float64)
    E = jp["w1"].shape[0]
    h = [x @ np.asarray(jp["w1"][e], np.float64) for e in range(E)]
    if act == "swiglu":
        h = [a / (1 + np.exp(-a)) * (x @ np.asarray(jp["w3"][e], np.float64))
             for e, a in enumerate(h)]
    elif act == "sq_relu":
        h = [np.maximum(a, 0) ** 2 for a in h]
    else:
        h = [np.asarray(jax.nn.gelu(jnp.asarray(a), approximate=True), np.float64) for a in h]
    f = np.stack([a @ np.asarray(jp["w2"][e], np.float64) for e, a in enumerate(h)])
    T, k = top_i.shape
    kept = np.zeros((T, k), bool)
    for t in range(T):
        terms = [top_w[t, j] * f[top_i[t, j], t] for j in range(k)]
        res = sorted((np.abs(y[t] - sum(m * c for m, c in zip(mask, terms))).max(), mask)
                     for mask in itertools.product((0, 1), repeat=k))
        assert res[0][0] < 1e-4 < res[1][0], (t, res[:2])
        kept[t] = res[0][1]
    return kept


CASES = [  # act, dropless, n_groups, shared, dtype, weights, impl
    ("swiglu", True, 1, True, "f32", "dense", "dense"),
    ("swiglu", False, 1, True, "f32", "dense", "dense"),
    ("sq_relu", True, 1, True, "f32", "dense", "dense"),
    ("sq_relu", False, 1, False, "f32", "dense", "dense"),
    ("gelu", True, 1, False, "f32", "dense", "dense"),
    ("gelu", False, 1, True, "f32", "dense", "dense"),
    ("swiglu", True, 4, False, "f32", "dense", "dense"),
    ("swiglu", False, 4, False, "f32", "dense", "dense"),
    ("swiglu", True, 1, True, "bf16", "dense", "dense"),
    ("swiglu", False, 4, True, "bf16", "dense", "dense"),
    ("swiglu", True, 1, True, "bf16", "quantized", "dequant"),
    ("swiglu", False, 1, True, "bf16", "quantized", "kernel"),
    ("swiglu", True, 4, True, "bf16", "quantized", "kernel"),
    ("sq_relu", False, 1, False, "f32", "quantized", "kernel"),
]


@pytest.mark.parametrize("act,dropless,n_groups,shared,dtype,weights,impl", CASES)
def test_moe_ffn_matches_jax(act, dropless, n_groups, shared, dtype, weights, impl):
    E, k, T = 8, 2, 32
    rng = np.random.default_rng(CASES.index((act, dropless, n_groups, shared, dtype,
                                             weights, impl)))
    x = rng.standard_normal((T, D)).astype(np.float32)
    jp, tp = _both(E, shared, weights == "quantized")
    jc, tc = _cfgs(E, k, cf=1.0)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    kw = dict(act=act, dropless=dropless, n_groups=n_groups)
    jimpl = "dequant" if impl == "kernel" else impl
    jy, jaux = jax.jit(lambda a, p: JM.moe_ffn(a, p, jc, impl=jimpl, **kw))(jx, jp)
    ty, taux = TM.moe_ffn(tx, tp, tc, impl=impl, **kw)
    assert ty.dtype == tdt and ty.shape == (T, D)
    want = np.asarray(jy.astype(jnp.float32))
    atol = TOL if dtype == "f32" else TOL + BF16_TOL * np.abs(want).max()
    np.testing.assert_allclose(ty.float().numpy(), want, rtol=TOL, atol=atol)

    # routing: the experts JAX chooses (its lax.top_k on its own f32 routing)
    jw, ji = jax.lax.top_k(jax.nn.softmax(jnp.dot(jx.astype(jnp.float32), jp["router"]), -1), k)
    _, tw, ti = TM.route(tx, tp["router"], k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw / jw.sum(-1, keepdims=True)),
                               rtol=1e-6, atol=1e-7)
    # dispatch: the port's kept entries, per group
    G, cap = TM.capacity(T, tc, dropless=dropless, n_groups=n_groups)
    kept = np.concatenate([TM._dispatch(g_x, g_i, E, cap)[2].numpy() for g_x, g_i in
                           zip(tx.reshape(G, -1, D), ti.reshape(G, -1, k))])
    if dropless:
        assert jaux == {} and taux == {} and kept.all()
        return
    assert float(taux["moe_drop_frac"]) == float(jaux["moe_drop_frac"]) == 1 - kept.mean()
    assert 0 < kept.mean() < 1  # the capacity drops some entries here
    np.testing.assert_allclose(float(taux["moe_load_balance"]),
                               float(jaux["moe_load_balance"]), rtol=1e-6, atol=1e-6)
    if dtype == "f32" and weights == "dense":
        routed = np.asarray(jy, np.float64)
        if shared:
            routed -= np.asarray(jax.jit(lambda a, p: JM.expert_ffn(
                a, p["shared_w1"], p["shared_w3"], p["shared_w2"], act, "dense"))(jx, jp),
                np.float64)
        np.testing.assert_array_equal(
            kept, _jax_kept(routed, x, jp, tw.double().numpy(), ti.numpy(), act))


def test_top_k_ties_go_to_the_lower_expert():
    """Equal router columns give equal probabilities: JAX's top_k and the
    port's stable sort both take the lower expert index first."""
    E, k = 8, 3
    r = np.random.default_rng(3).standard_normal((D, E)).astype(np.float32)
    r[:, 5] = r[:, 1]
    r[:, 6] = r[:, 1]
    r[:, 7] = r[:, 2]
    x = np.random.default_rng(4).standard_normal((40, D)).astype(np.float32)
    _, ji = jax.lax.top_k(jax.nn.softmax(jnp.dot(jnp.asarray(x), jnp.asarray(r)), -1), k)
    _, _, ti = TM.route(torch.from_numpy(x), torch.from_numpy(r), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_expert_view_and_pas_kernel_expert_matmul_match_jax():
    """``PasmParams.select`` is a view of one expert (shape, bins, pad_k and
    the packed layout kept, no copy); ``_expert_matmul`` on ``pas_kernel``
    (K3's plain version, one call per expert) against the JAX Pallas PAS
    kernel in interpret mode, and on ``kernel`` against ``dequant``."""
    rng = np.random.default_rng(5)
    E, T, K, N = 2, 4, 9, 8  # odd K: the §3 K-pad row
    w = jpar.PasmParams.quantize(jnp.asarray(rng.standard_normal((E, K, N)), jnp.float32),
                                 16, iters=4).pack()
    tw = port_params({"w": w})["w"]
    one = tw.select(1)
    assert (one.kind, one.shape, one.bins, one.pad_k) == (tw.kind, tw.shape, tw.bins, tw.pad_k)
    assert one.idx.data_ptr() == tw.idx[1].data_ptr() and one.idx.shape == tw.idx.shape[1:]
    assert torch.equal(one.dense_matrix(), tw.dense_matrix()[1])
    with pytest.raises(ValueError, match="stacked"):
        one.select(0)
    buf = rng.standard_normal((E, T, K)).astype(np.float32)
    want = np.asarray(JM._expert_matmul(jnp.asarray(buf), w, jnp.float32, "pas_kernel"))
    got = TM._expert_matmul(torch.from_numpy(buf), tw, torch.float32, "pas_kernel")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    dq = TM._expert_matmul(torch.from_numpy(buf), tw, torch.float32, "dequant")
    k1 = TM._expert_matmul(torch.from_numpy(buf), tw, torch.float32, "kernel")
    np.testing.assert_allclose(k1.numpy(), dq.numpy(), rtol=1e-5, atol=1e-5)
    assert tpar.is_quantized(tw) and not tpar.is_quantized(torch.zeros(2, 2))


def test_capacity_rule_is_jax_rule():
    """The dropless cap (Tl up to 512 tokens a group, then 1.25x balanced)
    and the training cap, at the served shapes of deepseek-moe-16b."""
    c = MoEConfig(n_experts=64, top_k=6, d_expert=1408, capacity_factor=1.25)
    assert TM.capacity(4, c, dropless=True) == (1, 4)
    assert TM.capacity(512, c, dropless=True) == (1, 512)
    assert TM.capacity(4 * 384, c, dropless=True) == (1, 180)
    assert TM.capacity(1024, c, dropless=False) == (1, 120)
    assert TM.capacity(30, c, dropless=True, n_groups=4) == (1, 30)  # 4 ∤ 30
    assert TM.capacity(32, c, dropless=False, n_groups=4) == (4, 1)
