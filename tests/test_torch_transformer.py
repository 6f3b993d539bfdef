"""The port's dense transformer LM against the JAX package on the CPU.

Weights are drawn once by the JAX package and carried into the port
(:func:`repro_torch.interop.lm_params_from_numpy`), dense or quantized by
the JAX ``quantize_params``, so both packages compute from the same weights
and dictionaries.  Also here: the config registry, the layers, ``embed_lookup``
and the param surgery, K1 with bf16 activations (the LM's linears), and the
k-means quantile init.

Tolerance for the LM logits: the activations run in bf16 in both packages,
and the two frameworks round at other places (F.silu vs XLA's logistic,
fused vs separate elementwise ops), so logits of magnitude ~3 differ by a
few bf16 ulps: |Δ| ≤ 2.5 % of max |logit|.  A mismatch of the algorithm
(a mask, a rope position, a cache slot) moves them by O(1).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_lm import port_params
from repro import configs as jconfigs
from repro.core import params as jpar
from repro.core import pasm as jp
from repro.kernels import ops as jops
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import transformer as JT
from repro.nn import layers as JL
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import params as tpar
from repro_torch.core import pasm as tp
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.nn import layers as TL

ARCHS = ("qwen3-32b", "stablelm-3b", "nemotron-4-340b")
LOGIT_TOL = 0.025  # of max |logit|: bf16 rounding in two frameworks (above)


@functools.lru_cache(maxsize=None)
def _setup(arch: str, quant: bool):
    """JAX and port configs and params, dense or quantized (``dequant``)."""
    jc = jconfigs.get_config(arch, smoke=True)
    tc = tconfigs.get_config(arch, smoke=True)
    jparams = JT.init_params(jc, jax.random.PRNGKey(0))
    if quant:
        # the smoke matrices are small: lower the B ≪ N floor so they quantize
        kw = dict(enabled=True, impl="dequant", min_weight_elems=1024)
        jc, tc = jc.with_quant(**kw), tc.with_quant(**kw)
        jparams = jcommon.quantize_params(jparams, jc)
    return jc, tc, jparams, port_params(jparams)


def _impl(tc, impl):
    return tc.with_quant(impl=impl) if tc.quant.enabled else tc


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_configs_equal_jax():
    for arch in ARCHS + ("phi3-medium-14b",):
        for smoke in (False, True):
            a = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
            b = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
            assert a == b
            c = tconfigs.get_config(arch, smoke=smoke)
            assert c.n_params() == jconfigs.get_config(arch, smoke=smoke).n_params()
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.all_cells() == jconfigs.all_cells()
    for arch in set(tconfigs.ARCH_IDS) - set(ARCHS + ("phi3-medium-14b",)):
        with pytest.raises(NotImplementedError, match="item 8"):
            tconfigs.get_config(arch)
    moe = dataclasses.replace(tconfigs.get_config("qwen3-32b", smoke=True),
                              family="moe")
    with pytest.raises(NotImplementedError, match="item 8"):
        tapi.get_model(moe)
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")
    assert tapi.get_model(tconfigs.get_config("stablelm-3b")) is TT
    full = tconfigs.get_config("qwen3-32b")
    assert tapi.cache_len(full, tconfigs.get_shape("decode_32k")) == \
        japi.cache_len(jconfigs.get_config("qwen3-32b"), jconfigs.get_shape("decode_32k"))


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    sc = (rng.standard_normal(16) * 0.1).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    X, S, Bb = torch.from_numpy(x), torch.from_numpy(sc), torch.from_numpy(b)
    pos = np.array([[0, 5, 9], [3, 3, 100]])
    cj, sj = JL.rope(jnp.asarray(pos), 16, 1e6)
    ct, st = TL.rope(torch.from_numpy(pos), 16, 1e6)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    pairs = [
        (TL.rms_norm(X, S), JL.rms_norm(jnp.asarray(x), jnp.asarray(sc))),
        (TL.layer_norm(X, S, Bb), JL.layer_norm(jnp.asarray(x), jnp.asarray(sc), jnp.asarray(b))),
        (TL.sq_relu(X), JL.sq_relu(jnp.asarray(x))),
        (TL.gelu_ffn_act(X), JL.gelu_ffn_act(jnp.asarray(x))),
        (TL.swiglu(X, X), JL.swiglu(jnp.asarray(x), jnp.asarray(x))),
    ]
    c9, s9 = JL.rope(jnp.arange(9), 16, 1e4)
    c9t, s9t = TL.rope(torch.arange(9), 16, 1e4)
    pairs.append((TL.apply_rope(X, c9t[None], s9t[None]),
                  JL.apply_rope(jnp.asarray(x), c9[None], s9[None])))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-6, atol=2e-6)


def test_embed_lookup_dense_weight_dense_stack():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((40, 12)).astype(np.float32)
    toks = np.array([[0, 3, 39], [7, 7, 1]])
    cb = jnp.asarray(rng.standard_normal((1, 16)).astype(np.float32))
    jw = jpar.PasmParams.shared(jnp.asarray(rng.integers(0, 16, (40, 12)), jnp.uint8), cb).pack()
    tw = port_params({"e": jw})["e"]
    np.testing.assert_array_equal(tpar.embed_lookup(tw, torch.from_numpy(toks)).numpy(),
                                  np.asarray(jpar.embed_lookup(jw, jnp.asarray(toks))))
    np.testing.assert_array_equal(tpar.embed_lookup(torch.from_numpy(w), torch.from_numpy(toks)).numpy(),
                                  w[toks])
    np.testing.assert_array_equal(tpar.dense_weight(tw).numpy(),
                                  np.asarray(jpar.dense_weight(jw)))
    stack = rng.standard_normal((3, 24, 10)).astype(np.float32)
    js = jpar.PasmParams.shared(jnp.asarray(rng.integers(0, 16, (3, 24, 10)), jnp.uint8),
                                jnp.asarray(rng.standard_normal((3, 2, 16)).astype(np.float32))).pack()
    ts = port_params({"s": js})["s"]
    np.testing.assert_array_equal(
        tpar.dense_stack(ts, torch.float32).numpy(),
        np.asarray(jpar.dense_stack(js, jnp.float32)))
    assert tpar.dense_stack(torch.from_numpy(stack), torch.bfloat16).dtype == torch.bfloat16


def test_quantize_params_matches_jax():
    """The port's surgery quantizes the same leaves as the JAX package's;
    the byte and parameter accounting are equal; k-means on the port side
    agrees with the JAX dictionaries on ≥ 99.9 % of the indices."""
    jc, tc, jq, tq = _setup("qwen3-32b", True)
    _, _, jdense, tdense = _setup("qwen3-32b", False)
    mine = tcommon.quantize_params(tdense, tc)
    assert tcommon.weight_bytes(mine) == tcommon.weight_bytes(tq) == jcommon.weight_bytes(jq)
    assert tcommon.param_count(mine) == tcommon.param_count(tdense) == \
        jcommon.param_count(jq) == jcommon.param_count(jdense)
    a = mine["layers"][1]["attn"]["wq"]
    b = tq["layers"][1]["attn"]["wq"]
    assert (a.kind, a.shape, a.bins, a.pad_k) == (b.kind, b.shape, b.bins, b.pad_k) == \
        ("packed", tuple(jq["layers"]["attn"]["wq"].shape), 16, 0)
    same = (tp.unpack_int4(a.idx) == tp.unpack_int4(b.idx)).float().mean()
    assert float(same) >= 0.999
    assert torch.is_tensor(mine["embed"]) and torch.is_tensor(mine["layers"][0]["attn_norm"])
    off = tc.with_quant(enabled=False)
    assert tcommon.quantize_params(tdense, off) is tdense


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, quant):
    """Dense weights, or the JAX dictionaries on the port's ``dequant`` and
    ``kernel`` (K1's plain version here) against the JAX ``dequant`` path
    (its Pallas kernel computes the same function, up to the order of the
    sum, and takes minutes in interpret mode at these shapes)."""
    jc, tc0, jparams, tparams = _setup(arch, quant)
    impls = ("dequant", "kernel") if quant else ("dense",)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (2, 11)).astype(np.int32)
    lengths = np.array([11, 6], np.int32)  # slot 1 is right-padded
    nxt = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jl_fwd, _ = JT.forward(jparams, jnp.asarray(toks), jc)
    jcache = JT.init_caches(jc, 2, 24)
    jl_pre, jcache = JT.prefill(jparams, jnp.asarray(toks), jcache, jc,
                                lengths=jnp.asarray(lengths))
    jl_dec, _ = JT.decode_step(jparams, jnp.asarray(nxt), jcache, jc)
    for impl in impls:
        tc = _impl(tc0, impl)
        tl, aux = TT.forward(tparams, torch.from_numpy(toks), tc)
        assert tl.dtype == torch.bfloat16 and float(aux["moe_load_balance"]) == 0.0
        _close(tl, jl_fwd)
        tcache = TT.init_caches(tc, 2, 24, device="cpu")
        tl, tcache = TT.prefill(tparams, torch.from_numpy(toks), tcache, tc,
                                lengths=torch.from_numpy(lengths))
        _close(tl, jl_pre)
        assert [c.pos.tolist() for c in tcache["scan"]] == [[11, 6]] * tc.n_layers
        tl, tcache = TT.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        _close(tl, jl_dec)
        assert tcache["scan"][-1].pos.tolist() == [12, 7]


def test_tied_head_int8_cache_and_loss():
    """A tied head (the embedding's transpose, dense) and the int8 KV cache
    (``kv_bits=8``) through prefill + decode; ``lm_loss`` equals JAX's."""
    jc, tc, jparams, tparams = _setup("stablelm-3b", True)
    jc = dataclasses.replace(jc, tie_embeddings=True).with_quant(kv_bits=8)
    tc = dataclasses.replace(tc, tie_embeddings=True).with_quant(kv_bits=8, impl="kernel")
    jparams = {k: v for k, v in jparams.items() if k != "lm_head"}
    tparams = {k: v for k, v in tparams.items() if k != "lm_head"}
    toks = np.random.default_rng(2).integers(0, jc.vocab, (1, 9)).astype(np.int32)
    jcache, tcache = JT.init_caches(jc, 1, 16), TT.init_caches(tc, 1, 16, device="cpu")
    assert type(tcache["scan"][0]).__name__ == "QuantKVCache"
    jl, jcache = JT.prefill(jparams, jnp.asarray(toks), jcache, jc)
    tl, tcache = TT.prefill(tparams, torch.from_numpy(toks), tcache, tc)
    _close(tl, jl)
    jl, _ = JT.decode_step(jparams, jnp.asarray(toks[:, :1]), jcache, jc)
    tl, _ = TT.decode_step(tparams, torch.from_numpy(toks[:, :1]), tcache, tc)
    _close(tl, jl)
    logits = np.random.default_rng(3).standard_normal((2, 5, 7)).astype(np.float32)
    labels = np.random.default_rng(4).integers(0, 7, (2, 5))
    mask = (np.arange(5)[None] < np.array([[5], [3]])).astype(np.float32)
    np.testing.assert_allclose(
        float(tapi.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           torch.from_numpy(mask))),
        float(japi.lm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))),
        rtol=1e-6)


def test_model_surface_refuses_later_slices():
    tc = tconfigs.get_config("qwen3-32b", smoke=True)
    vit = dataclasses.replace(tc, frontend="vit")
    with pytest.raises(NotImplementedError, match="item 8"):
        TT.init_params(vit, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="item 10"):
        tcommon.ShardCtx(active=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        tpar.dense_stack(torch.zeros(2, 3, 4), torch.float32, spec=("model",))
    p = TT.init_params(tc, torch.Generator().manual_seed(0))
    assert len(p["layers"]) == tc.n_layers and p["embed"].device.type == "cpu"
    carry, ys = tcommon.maybe_scan(lambda c, x: (c + x, x * 2), 0, [1, 2, 3], True)
    assert carry == 6 and ys == [2, 4, 6]


@pytest.mark.parametrize("M,K,N,groups,packed", [
    (4, 64, 48, 1, True),
    (7, 96, 33, 2, True),
    (16, 40, 24, 1, False),
])
def test_k1_bf16_activations_match_jax_kernel(M, K, N, groups, packed):
    """K1 with bf16 ``x`` (the LM's linears): the plain version against the
    JAX kernel in interpret mode, which dequantizes each tile to bf16 and
    sums in f32 — equal up to the order of the sum (1e-4); through
    ``params.matmul`` the bf16 outputs agree to one bf16 ulp, and
    ``kernel`` and ``dequant`` agree to the same ulp."""
    rng = np.random.default_rng(M + K)
    idx = rng.integers(0, 16, size=(K, N)).astype(np.uint8)
    cb = rng.standard_normal((groups, 16)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()
    packed_idx = np.asarray(jp.pack_int4(jnp.asarray(idx))) if packed else idx
    meta = dict(shape=(K, N), bins=16, bits=4 if packed else 4, packed=packed)
    if not packed:
        meta["bits"] = jp.bits_for_bins(16)
    tj = jp.PASMTensor(idx=jnp.asarray(packed_idx), codebook=jnp.asarray(cb), **meta)
    tt = interop.pasm_tensor_from_numpy(dict(idx=packed_idx, codebook=cb, **meta),
                                        device="cpu")
    want = np.asarray(jops.pasm_matmul(jx, tj, interpret=True).astype(jnp.float32))
    got = tops.pasm_matmul(tx, tt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # through the dispatch: output in x's dtype, kernel == dequant to an ulp
    jw = jpar.PasmParams.shared(jnp.asarray(idx), jnp.asarray(cb))
    jw = jw.pack() if packed else jw
    tw = port_params({"w": jw})["w"]
    yj = np.asarray(jpar.matmul(jx, jw, impl="kernel", interpret=True).astype(jnp.float32))
    yk = tpar.matmul(tx, tw, impl="kernel")
    yd = tpar.matmul(tx, tw, impl="dequant")
    assert yk.dtype == yd.dtype == torch.bfloat16
    ulp = 2.0 ** -7 * np.abs(yj).max()
    assert np.abs(yk.float().numpy() - yj).max() <= ulp
    assert (yk.float() - yd.float()).abs().max() <= ulp


def test_kmeans_init_is_jnp_quantile_and_takes_any_size():
    """The quantile init equals ``jnp.quantile`` bitwise at small sizes; a
    group past torch.quantile's 2**24 cap quantizes with bounded temporaries
    (chunks of ``KMEANS_CHUNK`` values)."""
    from repro_torch.core.pasm import _quantile_init

    for n, bins in ((1, 4), (5, 16), (1000, 16), (4097, 256)):
        v = np.random.default_rng(n).standard_normal(n).astype(np.float32)
        want = jnp.quantile(jnp.asarray(v), (jnp.arange(bins, dtype=jnp.float32) + 0.5) / bins)
        np.testing.assert_array_equal(_quantile_init(torch.from_numpy(v), bins).numpy(),
                                      np.asarray(want))
    big = torch.randn((1 << 24) + 2, 1, generator=torch.Generator().manual_seed(0))
    cb, idx = tp.kmeans_codebook(big, 16, iters=1)
    assert tuple(idx.shape) == tuple(big.shape) and bool((cb[0][1:] > cb[0][:-1]).all())
    assert tp.KMEANS_CHUNK * 16 * 4 <= 1 << 28  # one (chunk, B) f32 temporary
    err = (tp.codebook_lookup(cb, idx) - big).abs().mean()
    assert float(err) < 0.1  # 16 bins over N(0, 1): mean error ≈ 0.06
