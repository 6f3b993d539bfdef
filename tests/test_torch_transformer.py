"""The port's transformer LM (dense, MoE, the vit prefix) against the JAX
package on the CPU.

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
import contextlib
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
from repro.nn import moe as JM
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.core import params as tpar
from repro_torch.core import pasm as tp
from repro_torch.kernels import ops as tops
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as TT
from repro_torch.nn import layers as TL
from repro_torch.nn import moe as TM

ARCHS = ("qwen3-32b", "stablelm-3b", "nemotron-4-340b")
MOE_ARCHS = ("deepseek-moe-16b", "kimi-k2-1t-a32b")
PORTED = ARCHS + MOE_ARCHS + ("phi3-medium-14b", "internvl2-26b", "mamba2-130m",
                               "recurrentgemma-2b", "whisper-tiny")
LOGIT_TOL = 0.025  # of max |logit|: bf16 rounding in two frameworks (above)
# a routing near-tie: an expert within 2^-5 of the k-th largest probability
# (the bf16 ulps above move router probabilities by about 1e-3 of themselves)
TIE = 2.0 ** -5


@functools.lru_cache(maxsize=None)
def _jax_init(arch: str):
    cfg = jconfigs.get_config(arch, smoke=True)
    if arch in ARCHS:
        return JT.init_params(cfg, jax.random.PRNGKey(0))
    # the MoE and VLM configs: jitted, as eager tracing of the init costs
    # seconds (the same laws)
    return jax.jit(lambda k: JT.init_params(cfg, k))(jax.random.PRNGKey(0))


def _jit(fn, *args, **kw):
    """``fn(*args, **kw)`` through ``jax.jit`` (a fresh trace: spies run)
    with the config and the other non-array arguments closed over."""
    arrays = {k: v for k, v in kw.items() if v is not None}
    return jax.jit(lambda a, k: fn(*a, **k))(args, arrays)


@functools.lru_cache(maxsize=None)
def _setup(arch: str, quant: bool):
    """JAX and port configs and params, dense or quantized (``dequant``)."""
    jc = jconfigs.get_config(arch, smoke=True)
    tc = tconfigs.get_config(arch, smoke=True)
    jparams = _jax_init(arch)
    if quant:
        # the smoke matrices are small: lower the B ≪ N floor so they quantize
        kw = dict(enabled=True, impl="dequant", min_weight_elems=1024)
        jc, tc = jc.with_quant(**kw), tc.with_quant(**kw)
        if arch in ARCHS:
            jparams = jcommon.quantize_params(jparams, jc)
        else:  # jitted: the same dictionaries, without eager tracing
            jparams = jax.jit(lambda p: jcommon.quantize_params(p, jc))(jparams)
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
    for arch in PORTED:
        for smoke in (False, True):
            a = dataclasses.asdict(jconfigs.get_config(arch, smoke=smoke))
            b = dataclasses.asdict(tconfigs.get_config(arch, smoke=smoke))
            assert a == b
            c = tconfigs.get_config(arch, smoke=smoke)
            j = jconfigs.get_config(arch, smoke=smoke)
            assert (c.n_params(), c.n_active_params()) == (j.n_params(), j.n_active_params())
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.all_cells() == jconfigs.all_cells()
    # every arch of the JAX package is ported: the audio family too
    assert set(tconfigs.ARCH_IDS) == set(PORTED)
    from repro_torch.models import encdec as TE

    for family in ("audio",):
        audio = dataclasses.replace(tconfigs.get_config("qwen3-32b", smoke=True),
                                    family=family)
        assert tapi.get_model(audio) is TE
        assert japi.get_model(audio).__name__ == "repro.models.encdec"
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")
    for arch in ("stablelm-3b", "deepseek-moe-16b", "kimi-k2-1t-a32b", "internvl2-26b"):
        assert tapi.get_model(tconfigs.get_config(arch)) is TT
    for arch in ("qwen3-32b", "internvl2-26b"):
        for shape in ("decode_32k", "train_4k"):
            assert tapi.cache_len(tconfigs.get_config(arch), tconfigs.get_shape(shape)) == \
                japi.cache_len(jconfigs.get_config(arch), jconfigs.get_shape(shape))


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


@contextlib.contextmanager
def _moe_inputs(mod, log: list):
    """Record what each ``mod.moe_ffn`` call routes: ``(x as f32 numpy,
    router as numpy)``; inside the JAX package's scan through a debug
    callback, which runs with the values in layer order."""
    inner = mod.moe_ffn

    def spy(x, params, cfg, **kw):
        if torch.is_tensor(x):
            log.append((x.float().numpy(), params["router"].numpy()))
        else:
            jax.debug.callback(lambda a, r: log.append((np.array(a), np.array(r))),
                               x.astype(jnp.float32), params["router"], ordered=True)
        return inner(x, params, cfg, **kw)

    mod.moe_ffn = spy
    try:
        yield log
    finally:
        mod.moe_ffn = inner


def _flips(jlog, tlog, k: int, seq: int = 0) -> dict:
    """Where the packages' chosen experts part, per group of rows: the
    whole batch under a capacity (``seq=0``: a changed expert moves later
    tokens' queue positions), else each sequence of ``seq`` rows (dropless:
    only attention carries a change, to later positions).  Returns ``{group:
    first differing flat row}``, taken at the group's first MoE call with a
    difference; every difference there must be a near-tie in JAX's own
    probabilities (the expert the port took within ``TIE`` of JAX's k-th).
    The rows before a group's entry are unaffected by it."""
    assert len(jlog) == len(tlog)
    first: dict = {}
    for (xj, r), (xt, _) in zip(jlog, tlog):
        pj = np.asarray(jax.nn.softmax(jnp.dot(jnp.asarray(xj), jnp.asarray(r)), -1))
        ij = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(pj), k)[1]), -1)
        it = np.sort(TM.route(torch.from_numpy(xt), torch.from_numpy(r), k)[2].numpy(), -1)
        new = {}
        for t in np.flatnonzero((ij != it).any(-1)):
            g = int(t) // seq if seq else 0
            if g in first:
                continue  # already parted at an earlier layer
            kth = np.sort(pj[t])[-k]
            extra = set(it[t]) - set(ij[t])
            assert all(pj[t, e] >= kth * (1 - TIE) for e in extra), (t, pj[t], ij[t], it[t])
            new.setdefault(g, int(t))
        first.update(new)
    return first


def _close_rows(got: torch.Tensor, want, rows) -> None:
    """:func:`_close` on the given rows of ``(B, S, V)`` logits flattened
    to ``(B·S, V)``, scaled by the max |logit| of all rows."""
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape and len(rows)
    V = want.shape[-1]
    d = np.abs(got.reshape(-1, V)[rows] - want.reshape(-1, V)[rows]).max()
    assert d <= LOGIT_TOL * np.abs(want).max(), (d, np.abs(want).max())


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_prefill_decode_match_jax(arch, quant):
    """deepseek-moe-16b and kimi-k2-1t-a32b (a leading dense layer, then
    MoE layers; capacity routing in ``forward``, dropless in ``prefill`` and
    ``decode_step``) as :func:`test_forward_prefill_decode_match_jax` holds
    the dense family.  Both packages route the same bf16 activations up to
    an ulp, so a token whose k-th and (k+1)-th experts are a near-tie may
    take the other one in the port: every such difference must be a
    near-tie, and the logits are compared on the rows it cannot reach
    (:func:`_flips`).  The MoE terms: the same drop fraction (up to the
    f32 sum over layers) when no choice differs; the balance loss within
    1e-2."""
    jc, tc0, jparams, tparams = _setup(arch, quant)
    k, S = jc.moe.top_k, 11
    impls = ("dequant", "kernel") if quant else ("dense",)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (2, S)).astype(np.int32)
    lengths = np.array([S, 6], np.int32)  # slot 1 is right-padded
    nxt = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jlog = {c: [] for c in ("fwd", "pre", "dec")}
    fwd = lambda p, t: JT.forward(p, t, jc)  # noqa: E731
    pre = lambda p, t, c, lengths: JT.prefill(p, t, c, jc, lengths=lengths)  # noqa: E731
    dec = lambda p, t, c: JT.decode_step(p, t, c, jc)  # noqa: E731
    with _moe_inputs(JM, jlog["fwd"]):
        jl_fwd, jaux = _jit(fwd, jparams, jnp.asarray(toks))
    jcache = JT.init_caches(jc, 2, 24)
    with _moe_inputs(JM, jlog["pre"]):
        jl_pre, jcache = _jit(pre, jparams, jnp.asarray(toks), jcache,
                              lengths=jnp.asarray(lengths))
    with _moe_inputs(JM, jlog["dec"]):
        jl_dec, _ = _jit(dec, jparams, jnp.asarray(nxt), jcache)
    n_moe = jc.n_layers - jc.moe.first_dense_layers
    assert [len(v) for v in jlog.values()] == [n_moe] * 3
    for impl in impls:
        tc = _impl(tc0, impl)
        tlog = {c: [] for c in jlog}
        with _moe_inputs(TM, tlog["fwd"]):
            tl, aux = TT.forward(tparams, torch.from_numpy(toks), tc)
        first = _flips(jlog["fwd"], tlog["fwd"], k).get(0, 2 * S)
        _close_rows(tl, jl_fwd, np.arange(first))
        if first == 2 * S:
            assert abs(float(aux["moe_drop_frac"]) - float(jaux["moe_drop_frac"])) <= 1e-6
        np.testing.assert_allclose(float(aux["moe_load_balance"]),
                                   float(jaux["moe_load_balance"]), rtol=1e-2)
        tcache = TT.init_caches(tc, 2, 24, device="cpu")
        assert len(tcache["dense"]) == len(jcache["dense"]) == jc.moe.first_dense_layers
        with _moe_inputs(TM, tlog["pre"]):
            tl, tcache = TT.prefill(tparams, torch.from_numpy(toks), tcache, tc,
                                    lengths=torch.from_numpy(lengths))
        first = _flips(jlog["pre"], tlog["pre"], k, seq=S)
        last = np.arange(2) * S + lengths - 1  # each slot's last real row
        slots = [b for b in range(2) if first.get(b, last[b] + 1) > last[b]]
        _close_rows(tl[:, 0], jl_pre[:, 0], slots)
        assert [c.pos.tolist() for c in tcache["dense"] + tcache["scan"]] == \
            [[S, 6]] * tc.n_layers
        with _moe_inputs(TM, tlog["dec"]):
            tl, tcache = TT.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        # a slot whose prefill took another expert decodes from another cache
        first = _flips(jlog["dec"], tlog["dec"], k, seq=1)
        _close_rows(tl[:, 0], jl_dec[:, 0], [b for b in slots if b not in first])
        assert [c.pos.tolist() for c in tcache["dense"] + tcache["scan"]] == \
            [[S + 1, 7]] * tc.n_layers


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
def test_vit_prefix_matches_jax(quant):
    """internvl2-26b: the projected patch prefix (``vproj``, dequantized on
    every impl: no kernel launch) ahead of the tokens; forward's logits
    cover the tokens only; prefill writes prefix + prompt to the cache
    (positions ``lengths + n_prefix``); decode continues from there."""
    jc, tc0, jparams, tparams = _setup("internvl2-26b", quant)
    rng = np.random.default_rng(11)
    P = jc.frontend_tokens
    fe = rng.standard_normal((2, P, jc.frontend_dim)).astype(np.float32)
    toks = rng.integers(0, jc.vocab, (2, 9)).astype(np.int32)
    lengths = np.array([9, 5], np.int32)
    nxt = rng.integers(0, jc.vocab, (2, 1)).astype(np.int32)
    jfe = jnp.asarray(fe, jnp.bfloat16)
    fwd = lambda p, t, frontend_embeds=None: JT.forward(  # noqa: E731
        p, t, jc, frontend_embeds=frontend_embeds)
    jl_fwd, _ = _jit(fwd, jparams, jnp.asarray(toks), frontend_embeds=jfe)
    jcache = JT.init_caches(jc, 2, 32)
    jl_pre, jcache = _jit(lambda p, t, c, **kw: JT.prefill(p, t, c, jc, **kw), jparams,
                          jnp.asarray(toks), jcache, lengths=jnp.asarray(lengths),
                          frontend_embeds=jfe)
    jl_dec, _ = _jit(lambda p, t, c: JT.decode_step(p, t, c, jc), jparams,
                     jnp.asarray(nxt), jcache)
    tfe = torch.from_numpy(fe).bfloat16()
    for impl in (("dequant", "kernel") if quant else ("dense",)):
        tc = _impl(tc0, impl)
        tl, _ = TT.forward(tparams, torch.from_numpy(toks), tc, frontend_embeds=tfe)
        assert tl.shape == (2, 9, tc.vocab)
        _close(tl, jl_fwd)
        tcache = TT.init_caches(tc, 2, 32, device="cpu")
        tl, tcache = TT.prefill(tparams, torch.from_numpy(toks), tcache, tc,
                                lengths=torch.from_numpy(lengths), frontend_embeds=tfe)
        _close(tl, jl_pre)
        assert [c.pos.tolist() for c in tcache["scan"]] == [[9 + P, 5 + P]] * tc.n_layers
        tl, tcache = TT.decode_step(tparams, torch.from_numpy(nxt), tcache, tc)
        _close(tl, jl_dec)
        assert tcache["scan"][0].pos.tolist() == [10 + P, 6 + P]
    # without frontend_embeds the VLM is a text LM
    jl, _ = _jit(fwd, jparams, jnp.asarray(toks))
    _close(TT.forward(tparams, torch.from_numpy(toks), tc0)[0], jl)
    spec = tapi.input_specs(tc0, tconfigs.get_shape("prefill_32k"))
    want = japi.input_specs(jc, jconfigs.get_shape("prefill_32k"))
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1]) for k, v in spec.items()} == \
        {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert spec["frontend_embeds"].device.type == "meta"


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
    """No serving refusal is left: an active ``ShardCtx`` runs the recurrent
    families (item 12b; on the (1, 1) mesh the unsharded function) and a
    KV-head count the model axis does not divide places the cache's
    positions over it (item 12c), ``dense_stack`` gives a placed stack's
    held block (item 12, ``tests/test_torch_lm_sharding.py``,
    ``tests/test_torch_rec_sharding.py``); the MoE, vit and audio surfaces
    are served (the audio frontend's log-mel spec equals JAX's)."""
    tc = tconfigs.get_config("qwen3-32b", smoke=True)
    audio = dataclasses.replace(tc, family="audio", frontend="audio")
    spec = tapi.frontend_spec(audio, 2)
    assert tuple(spec.shape) == (2, audio.n_mels, 2 * audio.frontend_tokens)
    assert spec.dtype == torch.bfloat16 and spec.device.type == "meta"
    specs = tapi.input_specs(audio, tconfigs.get_shape("train_4k"))
    jaudio = dataclasses.replace(jconfigs.get_config("qwen3-32b", smoke=True),
                                 family="audio", frontend="audio")
    jspecs = japi.input_specs(jaudio, jconfigs.get_shape("train_4k"))
    assert {k: tuple(v.shape) for k, v in specs.items()} == \
        {k: tuple(v.shape) for k, v in jspecs.items()}
    vit = dataclasses.replace(tc, frontend="vit", frontend_tokens=3, frontend_dim=8)
    assert "vproj" in TT.init_params(vit, torch.Generator().manual_seed(0))
    from repro_torch.launch.mesh import make_conv_mesh
    from repro_torch.models import sharding as tsh
    from repro_torch.models import ssm_lm as TS

    sctx = tcommon.ShardCtx(active=True, mesh=make_conv_mesh((1, 1), device="cpu"))
    assert sctx.active and sctx.tp == 1 and sctx.dp == 1
    stack = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    assert torch.equal(tpar.dense_stack(stack, torch.float32), stack)
    mcfg = tconfigs.get_config("mamba2-130m", smoke=True)
    mp = TS.init_params(mcfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 2), dtype=torch.long)
    assert torch.equal(TS.forward(mp, toks, mcfg, sctx)[0], TS.forward(mp, toks, mcfg)[0])
    two = dataclasses.replace(sctx, mesh=dataclasses.replace(
        sctx.mesh, shape=(1, 2), coords=(0, 0)))
    odd = dataclasses.replace(tc, n_kv_heads=1)
    placed = tsh.place_caches(odd, TT.init_caches(odd, 1, 8, device="cpu"), two.mesh,
                              two.batch)
    assert placed["scan"][0].seq_shards == 2 and placed["scan"][0].k.shape[1] == 4
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
