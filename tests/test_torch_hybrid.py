"""The port's RG-LRU hybrid (``nn/rglru.py``, ``models/hybrid.py``:
recurrentgemma-2b) against the JAX package on the CPU.

The RG-LRU scan, its decode step and the depthwise conv take the same
numpy inputs as ``repro.nn.rglru``: in f32 within ``|Δ| <= 1e-5 +
1e-4·|jax|`` (the doubling scan composes the steps in another order than
``associative_scan``); the bf16 conv bitwise (both round every product and
sum to bf16).  The model runs at 8 layers (2 scanned (R, R, A) groups and
the 2-layer recurrent tail), so a group carried across in the wrong order
shows, with the JAX package's weights (jitted), dense or quantized by the
JAX ``quantize_params``.

Tolerance of the bf16 logits: ``HYBRID_LOGIT_TOL`` = 8 % of max |logit|.
The RG-LRU gates amplify bf16 noise: JAX's own logits move by 3.4–5.8 % of
their max at 5 and 8 layers when its embeddings move by one bf16 ulp
(2.5 % bounds the dense family's 1.2–1.9 %), and the two frameworks round
at other places (XLA keeps fused intermediates in f32).  What that
tolerance cannot resolve is held with f32 activations in both packages
(:func:`f32_activations`): within 1e-4 of max |logit|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import f32_activations, port_params

from repro import configs as jconfigs
from repro.models import common as jcommon
from repro.models import hybrid as JH
from repro.nn import rglru as JR
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import hybrid as TH
from repro_torch.nn import rglru as TR
from repro_torch.serve.engine import Engine

ARCH = "recurrentgemma-2b"
LAYERS = 8  # 2 groups of (R, R, A) + a 2-layer tail
HYBRID_LOGIT_TOL = 0.08  # of max |logit| (above)
F32_TOL = 1e-4  # of max |logit|, f32 activations in both


def _close_f32(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _lru_params(W=16, seed=0):
    rng = np.random.default_rng(seed)
    p = {"w_a": rng.standard_normal((W, W)) * W ** -0.5,
         "w_x": rng.standard_normal((W, W)) * W ** -0.5,
         "b_a": rng.standard_normal(W) * 0.1, "b_x": rng.standard_normal(W) * 0.1,
         "lam": np.linspace(0.5, 4.0, W)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("S,init", [(1, False), (7, False), (33, True), (64, True)])
def test_rg_lru_scan_matches_jax(S, init):
    """The doubling scan (⌈log2 S⌉ steps; 33 is past a power of two)
    against ``associative_scan``, with and without a carried state."""
    jp, tp = _lru_params()
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, 16)).astype(np.float32)
    h0 = rng.standard_normal((2, 16)).astype(np.float32)
    jy, jh = jax.jit(JR.rg_lru_scan)(jnp.asarray(x), jp,
                                     jnp.asarray(h0) if init else None)
    ty, th = TR.rg_lru_scan(torch.from_numpy(x), tp,
                            init_h=torch.from_numpy(h0) if init else None)
    assert th.dtype == torch.float32
    _close_f32(ty, jy)
    _close_f32(th, jh)


def test_rg_lru_decode_steps_match_jax_and_the_scan():
    jp, tp = _lru_params()
    x = np.random.default_rng(1).standard_normal((2, 9, 16)).astype(np.float32)
    jh = th = None
    for t in range(9):
        jy, jh = JR.rg_lru_decode_step(jnp.asarray(x[:, t]), jp,
                                       jnp.zeros((2, 16)) if jh is None else jh)
        ty, th = TR.rg_lru_decode_step(torch.from_numpy(x[:, t]), tp,
                                       torch.zeros((2, 16)) if th is None else th)
        _close_f32(ty, jy)
        _close_f32(th, jh)
    _, hs = TR.rg_lru_scan(torch.from_numpy(x), tp)
    np.testing.assert_allclose(th.numpy(), hs.numpy(), rtol=1e-4, atol=1e-5)
    # a long sequence stays finite: no exp of a cumulative log-decay
    long = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 300, 16))
                            .astype(np.float32))
    assert bool(torch.isfinite(TR.rg_lru_scan(long, tp)[0]).all())


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_causal_conv_and_decode_step_match_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 16)).astype(np.float32)
    w = (rng.standard_normal((4, 16)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype is np.float32 else \
        (jnp.bfloat16, torch.bfloat16)
    jx, tx = jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    jy = JR.causal_conv1d(jx, jnp.asarray(w), jnp.asarray(b))
    ty = TR.causal_conv1d(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert ty.dtype == tdt
    want = np.asarray(jy.astype(jnp.float32))
    if tdt == torch.bfloat16:
        np.testing.assert_array_equal(ty.float().numpy(), want)
    else:
        _close_f32(ty, want)
    # decode: the window after 3 inputs, then one token at a time
    jwin, twin = jx[:, :3], TR.conv_window(tx[:, :3], 4)
    assert torch.equal(twin, tx[:, :3])
    # the decode step sums in f32 and rounds once (both packages), the conv
    # rounds each of its products and sums to bf16: a few ulps of max|y|
    tol = dict(rtol=0, atol=2.0 ** -6) if tdt == torch.bfloat16 else dict(rtol=1e-5,
                                                                          atol=1e-5)
    for t in range(3, 10):
        jo, jwin = JR.conv1d_decode_step(jx[:, t], jnp.asarray(w), jnp.asarray(b), jwin)
        to, twin = TR.conv1d_decode_step(tx[:, t], torch.from_numpy(w),
                                         torch.from_numpy(b), twin)
        if tdt == torch.bfloat16:  # both sum in f32 and round once
            np.testing.assert_array_equal(to.float().numpy(),
                                          np.asarray(jo.astype(jnp.float32)))
        else:
            _close_f32(to, jo)
        np.testing.assert_allclose(to.float().numpy(), ty[:, t].float().numpy(), **tol)
    # a window shorter than the conv is left-padded with the zeros the conv
    # assumes before the first input
    short = TR.conv_window(tx[:, :1], 4)
    assert short.shape == (2, 3, 16) and not short[:, :2].any()
    assert torch.equal(short[:, 2], tx[:, 0])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(quant: bool):
    """JAX and port configs (8 layers) and params, dense or quantized."""
    jc = dataclasses.replace(jconfigs.get_config(ARCH, smoke=True), n_layers=LAYERS)
    tc = dataclasses.replace(tconfigs.get_config(ARCH, smoke=True), n_layers=LAYERS)
    jparams = jax.jit(lambda k: JH.init_params(jc, k))(jax.random.PRNGKey(0))
    if quant:
        kw = dict(enabled=True, impl="dequant", min_weight_elems=1024)
        jc, tc = jc.with_quant(**kw), tc.with_quant(**kw)
        jparams = jax.jit(lambda p: jcommon.quantize_params(p, jc))(jparams)
    return jc, tc, jparams, port_params(jparams)


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _close(got: torch.Tensor, want, tol: float = HYBRID_LOGIT_TOL) -> None:
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_config_dispatch_and_param_tree():
    for smoke in (False, True):
        a = jconfigs.get_config(ARCH, smoke=smoke)
        b = tconfigs.get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
    assert tapi.get_model(tconfigs.get_config(ARCH)) is TH
    jc, tc, jparams, tparams = _setup(True)
    assert len(tparams["groups"]) == 2 and len(tparams["tail"]) == 2
    # each group carries its own slice of the JAX stack, in order
    for g in range(2):
        want = np.asarray(jparams["groups"]["l2"]["attn"]["wq"].idx[g])
        np.testing.assert_array_equal(tparams["groups"][g]["l2"]["attn"]["wq"].idx.numpy(),
                                      want)
        np.testing.assert_array_equal(tparams["groups"][g]["l0"]["lam"].numpy(),
                                      np.asarray(jparams["groups"]["l0"]["lam"][g]))
    # the gates and projections are quantized, lam and the conv stay dense
    rec = tparams["tail"][1]
    assert all(rec[k].idx is not None for k in ("rec_in", "w_a", "w_x", "rec_out"))
    assert torch.is_tensor(rec["lam"]) and torch.is_tensor(rec["conv_w"])
    p = TH.init_params(tc, torch.Generator().manual_seed(0))
    assert [sorted(g) for g in p["groups"]] == [["l0", "l1", "l2"]] * 2
    c = TH.init_caches(tc, 3, 40, device="cpu")
    assert c["groups"][1]["l2"]["k"].shape == (3, 16, 1, 32)  # min(window, seq)
    assert int(c["groups"][0]["l2"]["slot_pos"].max()) == -1
    assert TH.init_caches(tc, 3, 10, device="cpu")["groups"][0]["l2"]["v"].shape[1] == 10


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
def test_forward_prefill_decode_match_jax(quant):
    """Dense weights, or the JAX dictionaries on the port's ``dequant`` and
    ``kernel`` (K1's plain version) against the JAX ``dequant`` path: the
    logits and the caches after the prefill (LRU state, conv window, ring
    keys/values within the tolerance; ``slot_pos`` and positions
    exactly).  S = 11 fits the 16-slot ring; two decode steps."""
    jc, tc0, jparams, tparams = _setup(quant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (2, 11)).astype(np.int32)
    nxt = rng.integers(0, jc.vocab, (2, 2)).astype(np.int32)
    jl_fwd, _ = _jit(lambda p, t: JH.forward(p, t, jc), jparams, jnp.asarray(toks))
    jl_pre, jcache = _jit(lambda p, t, c: JH.prefill(p, t, c, jc), jparams,
                          jnp.asarray(toks), JH.init_caches(jc, 2, 24))
    dec = jax.jit(lambda p, t, c: JH.decode_step(p, t, c, jc))
    jl_dec, c = [], jcache
    for j in range(2):
        lg, c = dec(jparams, jnp.asarray(nxt[:, j:j + 1]), c)
        jl_dec.append(lg)
    for impl in (("dequant", "kernel") if quant else ("dense",)):
        tc = tc0.with_quant(impl=impl) if quant else tc0
        tl, aux = TH.forward(tparams, torch.from_numpy(toks), tc)
        assert tl.dtype == torch.bfloat16 and aux == {}
        _close(tl, jl_fwd)
        tcache = TH.init_caches(tc, 2, 24, device="cpu")
        tl, tcache = TH.prefill(tparams, torch.from_numpy(toks), tcache, tc)
        _close(tl, jl_pre)
        for g in range(2):
            for key in ("l0", "l1", "l2"):
                got, want = tcache["groups"][g][key], jcache["groups"][key]
                for f, t in got.items():
                    if f == "slot_pos":
                        np.testing.assert_array_equal(t.numpy(), np.asarray(want[f][g]))
                    else:
                        _close(t, want[f][g])
        for got, want in zip(tcache["tail"], jcache["tail"]):
            _close(got["h"], want["h"])
            _close(got["conv"], want["conv"])
        assert tcache["pos"].tolist() == np.asarray(jcache["pos"]).tolist() == [11, 11]
        for j in range(2):
            tl, tcache = TH.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), tcache, tc)
            _close(tl, jl_dec[j])
        assert tcache["pos"].tolist() == [13, 13]
        assert tcache["groups"][1]["l2"]["slot_pos"][0, :13].tolist() == list(range(13))
    with pytest.raises(ValueError, match="lengths"):
        TH.prefill(tparams, torch.from_numpy(toks), tcache, tc0,
                   lengths=torch.tensor([11, 6]))


def _run_f32(jc, tc, jparams, tparams, toks, nxt, S_cache):
    """Forward, prefill and decode steps of both packages with f32
    activations and caches."""
    with f32_activations(JH, TH):
        want = [_jit(lambda p, t: JH.forward(p, t, jc)[0], jparams, jnp.asarray(toks))]
        lg, c = _jit(lambda p, t, c: JH.prefill(p, t, c, jc), jparams, jnp.asarray(toks),
                     JH.init_caches(jc, toks.shape[0], S_cache, dtype=jnp.float32))
        want.append(lg)
        dec = jax.jit(lambda p, t, c: JH.decode_step(p, t, c, jc))
        for j in range(nxt.shape[1]):
            lg, c = dec(jparams, jnp.asarray(nxt[:, j:j + 1]), c)
            want.append(lg)
        got = [TH.forward(tparams, torch.from_numpy(toks), tc)[0]]
        lg, c = TH.prefill(tparams, torch.from_numpy(toks),
                           TH.init_caches(tc, toks.shape[0], S_cache, torch.float32,
                                          device="cpu"), tc)
        got.append(lg)
        for j in range(nxt.shape[1]):
            lg, c = TH.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), c, tc)
            got.append(lg)
    return got, want


def test_f32_activations_match_jax_tightly():
    """With f32 activations and caches in both packages the same algorithm
    agrees within ``F32_TOL`` of max |logit|: forward over S = 20 (past the
    16-slot window, so the local mask bites), a prefill of 20 into the
    ring (its last 16 positions kept) and 6 decode steps that wrap it."""
    jc, tc, jparams, tparams = _setup(False)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab, (2, 20)).astype(np.int32)
    nxt = rng.integers(0, jc.vocab, (2, 6)).astype(np.int32)
    got, want = _run_f32(jc, tc, jparams, tparams, toks, nxt, 40)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)


def test_ring_buffer_decode_past_window():
    """``tests/test_hybrid_ring.py`` for the port: prefill 4 and decode 20
    through the 16-slot ring, each step held against the port's own
    ``forward`` and JAX's (local attention by masking); the error after
    the wrap no larger than 4× the error before it (or the tolerance)."""
    jc, tc, jparams, tparams = _setup(True)
    tc = tc.with_quant(impl="kernel")
    total, P, W = 24, 4, tc.hybrid.local_window
    toks = np.random.default_rng(1).integers(0, jc.vocab, (1, total)).astype(np.int32)
    full_t = TH.forward(tparams, torch.from_numpy(toks), tc)[0].float().numpy()
    full_j = np.asarray(_jit(lambda p, t: JH.forward(p, t, jc)[0], jparams,
                             jnp.asarray(toks)).astype(jnp.float32))
    _, c = TH.prefill(tparams, torch.from_numpy(toks[:, :P]),
                      TH.init_caches(tc, 1, 64, device="cpu"), tc)
    errs = {"port": [], "jax": []}
    for t in range(P, total - 1):
        lg, c = TH.decode_step(tparams, torch.from_numpy(toks[:, t:t + 1]), c, tc)
        lg = lg[:, 0].float().numpy()
        errs["port"].append(np.abs(lg - full_t[:, t]).max())
        errs["jax"].append(np.abs(lg - full_j[:, t]).max())
    assert sorted(c["groups"][0]["l2"]["slot_pos"][0].tolist()) == list(range(total - 1 - W,
                                                                             total - 1))
    for who, full in (("port", full_t), ("jax", full_j)):
        e = np.array(errs[who])
        tol = HYBRID_LOGIT_TOL * np.abs(full).max()
        pre, post = e[: W - P].max(), e[W - P:].max()
        assert e.max() <= tol, (who, e)
        assert post <= max(4 * pre, tol / 2), (who, pre, post)


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompt_then_decode_matches_jax_forward(n):
    """Prompts shorter than ``conv_width − 1`` = 3 tokens: the JAX package's
    prefill stores a 1- or 2-row conv window that its decode cannot use;
    the port's is left-padded with zeros.  Prefill of ``n`` tokens and
    decode of the rest give the logits of JAX's ``forward``."""
    jc, tc, jparams, tparams = _setup(True)
    tc = tc.with_quant(impl="kernel")
    seq = np.random.default_rng(n).integers(0, jc.vocab, (2, 6)).astype(np.int32)
    want = np.asarray(_jit(lambda p, t: JH.forward(p, t, jc)[0], jparams,
                           jnp.asarray(seq)).astype(jnp.float32))
    lg, c = TH.prefill(tparams, torch.from_numpy(seq[:, :n]),
                       TH.init_caches(tc, 2, 8, device="cpu"), tc)
    assert c["tail"][0]["conv"].shape == (2, 3, tc.hybrid.lru_width)
    got = [lg]
    for t in range(n, seq.shape[1]):
        lg, c = TH.decode_step(tparams, torch.from_numpy(seq[:, t:t + 1]), c, tc)
        got.append(lg)
    got = torch.cat(got, dim=1).float().numpy()  # positions n-1 … 5
    assert np.abs(got - want[:, n - 1:]).max() <= HYBRID_LOGIT_TOL * np.abs(want).max()


def test_engine_tokens_match_jax_engine():
    """The same weights and traffic through both engines at the exact prompt
    length: the ring's ``slot_pos`` (int32) grafts slot by slot and a
    quarantined slot is scrubbed back to −1.  The first tokens agree, and
    each stream equals the JAX engine's up to its first difference.  There
    both engines have read the same tokens, and the two candidates must be
    a near-tie in both packages: their logits, from a prefill of that
    common prefix, within ``HYBRID_LOGIT_TOL`` of max |logit| of each other
    (the bf16 noise the gates amplify; past it a stream runs on other
    inputs)."""
    jc, tc, jparams, tparams = _setup(True)
    jc, tc = jc.with_quant(impl="dequant"), tc.with_quant(impl="kernel")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tc.vocab, size=int(n)) for n in (5, 9, 3, 12)]
    outs = []
    for eng in (JEngine(jc, jparams, batch_slots=2, max_seq=48),
                Engine(tc, tparams, batch_slots=2, max_seq=48)):
        reqs = [eng.submit(p, max_new=6) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([r.out for r in reqs])
    jo, to = outs
    assert [len(o) for o in to] == [len(o) for o in jo] == [6] * 4
    assert eng.calls["prefill"] == 4
    for prompt, t, j in zip(prompts, to, jo):
        diff = [i for i, (a, b) in enumerate(zip(t, j)) if a != b]
        if not diff:
            continue
        i = diff[0]
        seq = np.concatenate([prompt, np.asarray(j[:i])]).astype(np.int32)[None]
        jl, _ = _jit(lambda p, s, c: JH.prefill(p, s, c, jc), jparams, jnp.asarray(seq),
                     JH.init_caches(jc, 1, 48))
        tl, _ = TH.prefill(tparams, torch.from_numpy(seq),
                           TH.init_caches(tc, 1, 48, device="cpu"), tc)
        for lg in (np.asarray(jl.astype(jnp.float32))[0, -1], tl.float().numpy()[0, -1]):
            assert abs(lg[t[i]] - lg[j[i]]) <= HYBRID_LOGIT_TOL * np.abs(lg).max(), \
                (i, t, j, lg[t[i]], lg[j[i]])
    # the graft carried each slot's ring positions; the scrub resets them
    ring = eng.caches["groups"][0]["l2"]["slot_pos"]
    assert ring.dtype == torch.int32 and int(ring.max()) >= 0
    r = eng.submit(prompts[0], max_new=4)
    eng.step()
    slot = r.slot
    assert int(eng.caches["groups"][1]["l2"]["slot_pos"][slot].max()) >= 0
    eng._quarantine(r)
    eng._scrub_quarantined()
    assert (eng.caches["groups"][1]["l2"]["slot_pos"][slot] == -1).all()
    assert (eng.caches["tail"][0]["h"][slot] == 0).all()
    assert tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                         "--max-new", "2", "--max-seq", "32"]) == 0
