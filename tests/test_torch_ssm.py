"""The port's SSM family (``nn/ssm.py``, ``models/ssm_lm.py``: mamba2-130m)
against the JAX package on the CPU.

The SSD scan and its decode step take the same numpy inputs as
``repro.nn.ssm``, in f32: the same chunked algorithm summed in another
order, ``|Δ| <= 1e-5 + 1e-4·|jax|``.  The model's weights are drawn by the
JAX package (jitted) and carried across, dense or quantized by the JAX
``quantize_params`` (``min_weight_elems`` 1024, so every linear and the
head reach K1's plain version under ``kernel``).  Logits within
``LOGIT_TOL`` (2.5 % of max |logit|, ``tests/test_torch_transformer.py``):
JAX's own logits move by up to 2.2 % of their max when its embeddings move
by one bf16 ulp.  With f32 activations in both packages
(:func:`f32_activations`) the logits agree within 1e-4 of their max.
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
from repro.models import ssm_lm as JS
from repro.nn import ssm as JSSM
from repro.serve.engine import Engine as JEngine
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tlaunch
from repro_torch.models import api as tapi
from repro_torch.models import ssm_lm as TS
from repro_torch.nn import ssm as TSSM
from repro_torch.serve.engine import Engine

ARCH = "mamba2-130m"
LOGIT_TOL = 0.025  # of max |logit| (above)
F32_TOL = 1e-4  # of max |logit|, f32 activations in both


def _ssd_inputs(Bsz=2, T=32, H=4, P=8, G=1, N=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bsz, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bsz, T, H)) - 1)).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    Bm = (rng.standard_normal((Bsz, T, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((Bsz, T, G, N)) * 0.5).astype(np.float32)
    D = np.ones(H, np.float32)
    h0 = (rng.standard_normal((Bsz, H, P, N)) * 0.5).astype(np.float32)
    return x, dt, A, Bm, Cm, D, h0


def _close_f32(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("T,chunk,G,init", [
    (32, 8, 1, False),  # divisible
    (27, 8, 1, False),  # padded with dt = 0 steps
    (32, 8, 2, False),  # two B/C groups over four heads
    (27, 8, 2, True),  # padded, two groups, continuing from a state
    (5, 5, 1, True),  # one chunk: the model's min(chunk, S) on a short prompt
])
def test_ssd_scan_matches_jax(T, chunk, G, init):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T=T, G=G)
    kw = {"chunk": chunk}
    jy, jh = JSSM.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)), **kw,
                           init_state=jnp.asarray(h0) if init else None)
    ty, th = TSSM.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm, D)), **kw,
                           init_state=torch.from_numpy(h0) if init else None)
    assert ty.shape == (2, T, 4, 8) and th.dtype == torch.float32
    _close_f32(ty, jy)
    _close_f32(th, jh)
    # bf16 inputs: the scan runs in f32 and returns x's dtype
    yb, _ = TSSM.ssd_scan(torch.from_numpy(x).bfloat16(), *map(torch.from_numpy, (
        dt, A, Bm, Cm, D)), **kw)
    assert yb.dtype == torch.bfloat16


def test_ssd_scan_gradient_finite_where_a_chunk_decays_fast():
    """A chunk whose cumulative decay passes exp's f32 range (dt·A summing
    below −88): the masked half of ``exp(cum_t − cum_s)`` overflows, and a
    ``where`` after the exp gave the backward 0 · inf = NaN (the JAX scan
    does too; the port masks inside the exp, the same forward).  The
    gradients are finite and the token-by-token decode steps' within f32
    noise."""
    x, dt, A, Bm, Cm, D, h0 = map(torch.from_numpy, _ssd_inputs(T=16, G=1))
    dt = dt * 0 + 8.0  # dt·A ≤ −8 a step: −128 over a chunk of 16
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    y, _ = TSSM.ssd_scan(*leaves, chunk=16)
    got = torch.autograd.grad((y * torch.cos(y)).sum(), leaves)
    ref = [t.clone().requires_grad_() for t in (x, dt, A, Bm, Cm, D)]
    h, ys = torch.zeros_like(h0), []
    for t in range(16):
        yt, h = TSSM.ssd_decode_step(ref[0][:, t], ref[1][:, t], ref[2], ref[3][:, t],
                                     ref[4][:, t], ref[5], h)
        ys.append(yt)
    yr = torch.stack(ys, dim=1)
    want = torch.autograd.grad((yr * torch.cos(yr)).sum(), ref)
    assert torch.allclose(y, yr, rtol=1e-4, atol=1e-5)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches_jax_and_the_scan(G):
    x, dt, A, Bm, Cm, D, h0 = _ssd_inputs(T=6, G=G)
    jh, th = jnp.asarray(h0), torch.from_numpy(h0)
    for t in range(6):
        jy, jh = JSSM.ssd_decode_step(*map(jnp.asarray, (x[:, t], dt[:, t], A, Bm[:, t],
                                                         Cm[:, t], D)), jh)
        ty, th = TSSM.ssd_decode_step(*map(torch.from_numpy, (x[:, t], dt[:, t], A, Bm[:, t],
                                                              Cm[:, t], D)), th)
        _close_f32(ty, jy)
        _close_f32(th, jh)
    # six steps from h0 are the scan from h0
    _, hs = TSSM.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm, D)), chunk=4,
                          init_state=torch.from_numpy(h0))
    np.testing.assert_allclose(th.numpy(), hs.numpy(), rtol=1e-4, atol=1e-5)
    assert isinstance(TSSM.SSMState(h=th).h, torch.Tensor)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _setup(quant: bool):
    """JAX and port configs and params, dense or quantized (``dequant``)."""
    jc = jconfigs.get_config(ARCH, smoke=True)
    tc = tconfigs.get_config(ARCH, smoke=True)
    jparams = jax.jit(lambda k: JS.init_params(jc, k))(jax.random.PRNGKey(0))
    if quant:
        kw = dict(enabled=True, impl="dequant", min_weight_elems=1024)
        jc, tc = jc.with_quant(**kw), tc.with_quant(**kw)
        jparams = jax.jit(lambda p: jcommon.quantize_params(p, jc))(jparams)
    return jc, tc, jparams, port_params(jparams)


def _jit(fn, *args):
    return jax.jit(fn)(*args)


def _close(got: torch.Tensor, want, tol: float = LOGIT_TOL) -> None:
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


def test_config_and_dispatch():
    for smoke in (False, True):
        a = jconfigs.get_config(ARCH, smoke=smoke)
        b = tconfigs.get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
    assert tapi.get_model(tconfigs.get_config(ARCH)) is TS
    spec = tapi.input_specs(tconfigs.get_config(ARCH), tconfigs.get_shape("decode_32k"))
    assert tuple(spec["tokens"].shape) == (tconfigs.get_shape("decode_32k").global_batch, 1)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
def test_forward_prefill_decode_match_jax(quant):
    """Dense weights, or the JAX dictionaries on the port's ``dequant`` and
    ``kernel`` (K1's plain version) against the JAX ``dequant`` path: the
    logits, and the caches after the prefill (the SSM state in f32, the
    conv window in bf16, the positions exactly).  S = 11 pads the chunk of
    8; the decode runs two steps."""
    jc, tc0, jparams, tparams = _setup(quant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab, (2, 11)).astype(np.int32)
    nxt = rng.integers(0, jc.vocab, (2, 2)).astype(np.int32)
    jl_fwd, _ = _jit(lambda p, t: JS.forward(p, t, jc), jparams, jnp.asarray(toks))
    jl_pre, jcache = _jit(lambda p, t, c: JS.prefill(p, t, c, jc), jparams,
                          jnp.asarray(toks), JS.init_caches(jc, 2, 24))
    dec = jax.jit(lambda p, t, c: JS.decode_step(p, t, c, jc))
    jl_dec = []
    jc2 = jcache
    for j in range(2):
        lg, jc2 = dec(jparams, jnp.asarray(nxt[:, j:j + 1]), jc2)
        jl_dec.append(lg)
    for impl in (("dequant", "kernel") if quant else ("dense",)):
        tc = tc0.with_quant(impl=impl) if quant else tc0
        tl, aux = TS.forward(tparams, torch.from_numpy(toks), tc)
        assert tl.dtype == torch.bfloat16 and aux == {}
        _close(tl, jl_fwd)
        tcache = TS.init_caches(tc, 2, 24, device="cpu")
        tl, tcache = TS.prefill(tparams, torch.from_numpy(toks), tcache, tc)
        _close(tl, jl_pre)
        for i, layer in enumerate(tcache["layers"]):
            _close(layer["ssm"], jcache["ssm"][i])
            _close(layer["conv"], jcache["conv"][i])
            assert layer["conv"].dtype == torch.bfloat16
            assert layer["pos"].tolist() == np.asarray(jcache["pos"][i]).tolist() == [11, 11]
        for j in range(2):
            tl, tcache = TS.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), tcache, tc)
            _close(tl, jl_dec[j])
        assert tcache["layers"][-1]["pos"].tolist() == [13, 13]
    with pytest.raises(ValueError, match="lengths"):
        TS.prefill(tparams, torch.from_numpy(toks), tcache, tc0,
                   lengths=torch.tensor([11, 6]))


def test_f32_activations_match_jax_tightly():
    """The same algorithm without bf16 rounding: with f32 activations and
    caches in both packages, forward, prefill and two decode steps agree
    within ``F32_TOL`` of max |logit| (what the bf16 tolerance cannot
    resolve: a wrong decay, a shifted conv tap or chunk boundary)."""
    jc, tc, jparams, tparams = _setup(False)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jc.vocab, (2, 13)).astype(np.int32)
    nxt = rng.integers(0, jc.vocab, (2, 2)).astype(np.int32)
    with f32_activations(JS, TS):
        want = [_jit(lambda p, t: JS.forward(p, t, jc)[0], jparams, jnp.asarray(toks))]
        lg, c = _jit(lambda p, t, c: JS.prefill(p, t, c, jc), jparams, jnp.asarray(toks),
                     JS.init_caches(jc, 2, 24, dtype=jnp.float32))
        want.append(lg)
        for j in range(2):
            lg, c = _jit(lambda p, t, c: JS.decode_step(p, t, c, jc), jparams,
                         jnp.asarray(nxt[:, j:j + 1]), c)
            want.append(lg)
        got = [TS.forward(tparams, torch.from_numpy(toks), tc)[0]]
        lg, c = TS.prefill(tparams, torch.from_numpy(toks),
                           TS.init_caches(tc, 2, 24, torch.float32, device="cpu"), tc)
        got.append(lg)
        for j in range(2):
            lg, c = TS.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), c, tc)
            got.append(lg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)


@pytest.mark.parametrize("n", [1, 2])
def test_short_prompt_then_decode_matches_jax_forward(n):
    """Prompts shorter than ``d_conv − 1`` = 3 tokens: the JAX package's
    prefill cannot take them (no conv window), the port's left-pads the
    window with zeros.  Prefill of ``n`` tokens and decode of the rest
    give the logits of JAX's ``forward`` on the whole sequence."""
    jc, tc, jparams, tparams = _setup(True)
    tc = tc.with_quant(impl="kernel")
    seq = np.random.default_rng(n).integers(0, jc.vocab, (2, 6)).astype(np.int32)
    want = np.asarray(_jit(lambda p, t: JS.forward(p, t, jc)[0], jparams,
                           jnp.asarray(seq)).astype(jnp.float32))
    lg, c = TS.prefill(tparams, torch.from_numpy(seq[:, :n]),
                       TS.init_caches(tc, 2, 8, device="cpu"), tc)
    got = [lg]
    for t in range(n, seq.shape[1]):
        lg, c = TS.decode_step(tparams, torch.from_numpy(seq[:, t:t + 1]), c, tc)
        got.append(lg)
    got = torch.cat(got, dim=1).float().numpy()  # positions n-1 … 5
    assert np.abs(got - want[:, n - 1:]).max() <= LOGIT_TOL * np.abs(want).max()


def test_engine_tokens_match_jax_engine():
    """The same weights and traffic through both engines at the exact
    prompt length (each length its own bucket; a 1-token prompt, which
    the JAX engine cannot prefill, goes to the port's alone): the first
    tokens agree and the streams on ≥ 90 % of their tokens (bf16
    near-ties, as ``tests/test_torch_serve.py`` holds the dense family)."""
    jc, tc, jparams, tparams = _setup(True)
    jc, tc = jc.with_quant(impl="dequant"), tc.with_quant(impl="kernel")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tc.vocab, size=int(n)) for n in (5, 9, 3, 12)]
    outs = []
    for eng in (JEngine(jc, jparams, batch_slots=2, max_seq=48),
                Engine(tc, tparams, batch_slots=2, max_seq=48)):
        assert not eng.supports_lengths
        reqs = [eng.submit(p, max_new=6) for p in prompts[:2]]
        eng.step()
        reqs += [eng.submit(p, max_new=6) for p in prompts[2:]]
        eng.run_until_drained()
        outs.append([r.out for r in reqs])
    jo, to = outs
    assert [len(o) for o in to] == [6] * 4
    assert [o[0] for o in to] == [o[0] for o in jo]
    agree = np.mean([a == b for x, y in zip(to, jo) for a, b in zip(x, y)])
    assert agree >= 0.9, (to, jo)
    assert eng.calls["prefill"] == 4
    one = eng.submit(prompts[0][:1], max_new=3)
    eng.run_until_drained()
    assert one.done and len(one.out) == 3
    assert tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "2",
                         "--max-new", "2", "--max-seq", "32"]) == 0
