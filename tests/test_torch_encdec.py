"""The port's encoder–decoder (``models/encdec.py``: whisper-tiny) against
the JAX package on the CPU.

Weights are drawn once by the JAX package (jitted) and carried into the
port (``interop``): the stacked ``enc_layers``/``dec_layers`` become
per-layer lists, and a stem weight-shared by JAX's ``quantize_frontend``
arrives as ``ConvParams`` with JAX's own indices, so no check depends on
k-means agreeing.  The JAX side runs under ``jax.jit`` (its Pallas kernels
in interpret mode, as the JAX package's own CPU tests run them).

Tolerances: the bf16 logits within ``LOGIT_TOL`` = 2.5 % of max |logit| (the
two frameworks round at other places; the transformer tests' bound); the
same algorithm with f32 activations in both packages
(:func:`f32_activations`) within ``F32_TOL`` = 1e-4 of max |logit|; the
encoder output in f32 within 1e-4 of its max.
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
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import encdec as JE
from repro_torch import configs as tconfigs
from repro_torch.core.conv import ConvParams
from repro_torch.models import api as tapi
from repro_torch.models import encdec as TE

ARCH = "whisper-tiny"
LOGIT_TOL = 0.025  # of max |logit| (above)
F32_TOL = 1e-4  # of max |logit|, f32 activations in both
QUANT = dict(enabled=True, impl="dequant", min_weight_elems=1024)


@functools.lru_cache(maxsize=None)
def _setup(quant: bool):
    """JAX and port smoke configs and params: dense, or the layers
    quantized by the JAX ``quantize_params`` and the stem by its
    ``quantize_frontend`` (16 bins)."""
    jc = jconfigs.get_config(ARCH, smoke=True)
    tc = tconfigs.get_config(ARCH, smoke=True)
    jparams = jax.jit(lambda k: JE.init_params(jc, k))(jax.random.PRNGKey(0))
    if quant:
        jc, tc = jc.with_quant(**QUANT), tc.with_quant(**QUANT)
        jparams = jax.jit(lambda p: JE.quantize_frontend(
            jcommon.quantize_params(p, jc), bins=16))(jparams)
    return jc, tc, jparams, port_params(jparams)


def _inputs(seed: int, B: int = 2, S: int = 7):
    jc = jconfigs.get_config(ARCH, smoke=True)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jc.vocab, (B, S)).astype(np.int32)
    mel = rng.standard_normal((B, jc.n_mels, 2 * jc.frontend_tokens)).astype(np.float32)
    return toks, mel


def _close(got: torch.Tensor, want, tol: float = LOGIT_TOL) -> None:
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


@pytest.mark.parametrize("length,channels", [(16, 64), (1500, 384)])
def test_sinusoid_matches_jax(length, channels):
    """Within 1e-6 at the smoke length.  XLA's ``exp`` and torch's differ by
    one f32 ulp on some frequencies, which moves the angle at position p by
    up to p·2^-23 (every frequency is <= 1): at whisper's 1500 frames the
    bound grows with the position."""
    got = TE._sinusoid(length, channels)
    assert got.dtype == torch.float32 and got.shape == (length, channels)
    want = np.asarray(JE._sinusoid(length, channels))
    pos = np.arange(length, dtype=np.float64)[:, None]
    assert (np.abs(got.numpy() - want) <= 1e-6 + pos * 2.0 ** -22).all()
    if length <= 16:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_config_dispatch_param_tree_and_caches():
    for smoke in (False, True):
        a = jconfigs.get_config(ARCH, smoke=smoke)
        b = tconfigs.get_config(ARCH, smoke=smoke)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.n_params() == b.n_params()
    full = tconfigs.get_config(ARCH)
    assert (full.encoder_layers, full.n_layers, full.d_model, full.vocab,
            full.frontend_tokens, full.max_seq) == (4, 4, 384, 51865, 1500, 33000)
    assert tapi.get_model(full) is TE
    jc, tc, jparams, tparams = _setup(False)
    assert len(tparams["enc_layers"]) == tc.encoder_layers
    assert len(tparams["dec_layers"]) == tc.n_layers
    # an unquantized stem stays the init dict, as in JAX
    assert set(tparams["frontend"]["conv1"]) == {"kernel", "bias"}
    for i in range(tc.n_layers):
        np.testing.assert_array_equal(
            tparams["dec_layers"][i]["cross"]["wk"].numpy(),
            np.asarray(jparams["dec_layers"]["cross"]["wk"][i]))
    # the port's own init draws the same tree of the same shapes
    own = TE.init_params(tc, torch.Generator().manual_seed(0))
    assert own["frontend"]["conv2"]["kernel"].shape == (64, 64, 1, 3)
    for name, lists in (("enc_layers", own["enc_layers"]), ("dec_layers", own["dec_layers"])):
        jshapes = jax.tree.map(lambda x: x.shape[1:], jparams[name])
        tshapes = jax.tree.map(lambda x: tuple(x.shape), lists[0])
        assert tshapes == jshapes
    # the caches: per layer the JAX stack's slice, on the CPU and on meta
    jcache = JE.init_caches(jc, 3, 24)
    for dev in ("cpu", "meta"):
        tcache = TE.init_caches(tc, 3, 24, device=dev)
        assert len(tcache) == tc.n_layers
        for layer in tcache:
            assert layer["self"].k.shape == jcache["self"].k.shape[1:]
            assert layer["self"].pos.shape == jcache["self"].pos.shape[1:]
            assert layer["self"].pos.dtype == torch.int32
            for f in ("k", "v"):
                assert layer["cross"][f].shape == jcache["cross"][f].shape[1:]
                assert layer["cross"][f].dtype == torch.bfloat16
                assert layer["cross"][f].device.type == dev


def test_quantize_frontend_kinds_and_bins():
    """The port's ``quantize_frontend``: one 16-bin dictionary per stem
    conv, uint8 indices of the kernel's shape, the bias kept dense; and
    the carried JAX stem is the same kind, shape and dictionary."""
    jc, tc, jparams, tparams = _setup(True)
    dense = _setup(False)[3]
    own = TE.quantize_frontend(dense, bins=16)
    assert own["enc_layers"] is dense["enc_layers"]  # only the stem changes
    for name in ("conv1", "conv2"):
        p, carried, j = own["frontend"][name], tparams["frontend"][name], \
            jparams["frontend"][name]
        kernel = dense["frontend"][name]["kernel"]
        assert isinstance(p, ConvParams) and isinstance(carried, ConvParams)
        assert (p.kind, p.bins, p.kshape) == (carried.kind, carried.bins, carried.kshape) \
            == ("shared", 16, tuple(kernel.shape)) == (j.kind, j.bins, j.kshape)
        assert p.idx.dtype == torch.uint8 and p.codebook.shape == (16,)
        assert int(p.idx.max()) < 16
        torch.testing.assert_close(p.bias, dense["frontend"][name]["bias"])
        np.testing.assert_array_equal(carried.idx.numpy(), np.asarray(j.idx))
        # the dictionary stands in for the kernel: each weight's nearest entry
        err = (p.codebook[p.idx.long()] - kernel).abs().max()
        assert float(err) <= float((p.codebook[1:] - p.codebook[:-1]).abs().max())
    assert TE.quantize_frontend(dense, bins=8)["frontend"]["conv1"].bins == 8


@pytest.mark.parametrize("impl,engine", [("dequant", "einsum"), ("kernel", "kernel"),
                                         ("pas_kernel", "pas_kernel")])
def test_encode_matches_jax(impl, engine, monkeypatch):
    """The encoder with the stem weight-shared (JAX's dictionaries), on each
    stem engine of the impl → engine map: f32 activations in both packages,
    within 1e-4 of max |enc|."""
    from repro_torch.core import conv as tconv

    jc, tc, jparams, _ = _setup(False)
    jq = jax.jit(lambda p: JE.quantize_frontend(p, bins=16))(jparams)
    tq = port_params(jq)
    jc, tc = jc.with_quant(**dict(QUANT, impl=impl)), tc.with_quant(**dict(QUANT, impl=impl))
    seen = []

    def spy(x, p, conv, *, engine="auto", **kw):
        seen.append(engine)
        return conv2d(x, p, conv, engine=engine, **kw)

    conv2d = tconv.conv2d
    monkeypatch.setattr(TE, "conv2d", spy)
    _, mel = _inputs(3)
    with f32_activations(JE, TE):
        want = jax.jit(lambda p, m: JE.encode(p, m, jc))(jq, jnp.asarray(mel))
        got = TE.encode(tq, torch.from_numpy(mel), tc)
    assert seen == [engine, engine]
    assert got.dtype == torch.float32 and got.shape == (2, jc.frontend_tokens, jc.d_model)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
def test_forward_prefill_decode_match_jax(quant):
    """Dense weights, or the JAX dictionaries (layers and stem) on the
    port's ``kernel`` (K1's and the stem's plain versions here) against the
    JAX ``dequant`` path, on a seeded mel: the forward's logits; a
    right-padded prefill (lengths 7 and 4); its caches (self K/V and
    positions, the cross K/V); 4 decode steps."""
    jc, tc, jparams, tparams = _setup(quant)
    if quant:
        tc = tc.with_quant(impl="kernel")
    toks, mel = _inputs(7)
    lengths = np.array([7, 4], np.int32)
    nxt = np.random.default_rng(8).integers(0, jc.vocab, (2, 4)).astype(np.int32)
    jmel, tmel = jnp.asarray(mel), torch.from_numpy(mel)
    jl, _ = jax.jit(lambda p, t, m: JE.forward(p, t, jc, frontend_embeds=m))(
        jparams, jnp.asarray(toks), jmel)
    tl, aux = TE.forward(tparams, torch.from_numpy(toks), tc, frontend_embeds=tmel)
    assert tl.dtype == torch.bfloat16 and aux == {}
    _close(tl, jl)
    jl, jcache = jax.jit(lambda p, t, c, n, m: JE.prefill(
        p, t, c, jc, lengths=n, frontend_embeds=m))(
        jparams, jnp.asarray(toks), JE.init_caches(jc, 2, 24), jnp.asarray(lengths), jmel)
    tl, tcache = TE.prefill(tparams, torch.from_numpy(toks),
                            TE.init_caches(tc, 2, 24, device="cpu"), tc,
                            lengths=torch.from_numpy(lengths), frontend_embeds=tmel)
    assert tl.shape == (2, 1, jc.vocab)
    _close(tl, jl)
    for i, layer in enumerate(tcache):
        assert layer["self"].pos.tolist() == [7, 4]
        _close(layer["self"].k, jcache["self"].k[i])
        _close(layer["cross"]["v"], jcache["cross"]["v"][i])
    dec = jax.jit(lambda p, t, c: JE.decode_step(p, t, c, jc))
    for j in range(nxt.shape[1]):
        jl, jcache = dec(jparams, jnp.asarray(nxt[:, j:j + 1]), jcache)
        tl, tcache = TE.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), tcache, tc)
        _close(tl, jl)
    assert tcache[0]["self"].pos.tolist() == [11, 8]


def test_pas_kernel_forward_matches_jax():
    """Every weight-shared linear and the stem on the paper's two-phase PAS
    path (K3's plain version; JAX's Pallas kernel in interpret mode): the
    bf16 activations widen exactly to K3's f32 input."""
    jc, tc, jparams, tparams = _setup(True)
    jc, tc = jc.with_quant(impl="pas_kernel"), tc.with_quant(impl="pas_kernel")
    toks, mel = _inputs(12)
    jl, _ = jax.jit(lambda p, t, m: JE.forward(p, t, jc, frontend_embeds=m))(
        jparams, jnp.asarray(toks), jnp.asarray(mel))
    tl, _ = TE.forward(tparams, torch.from_numpy(toks), tc,
                       frontend_embeds=torch.from_numpy(mel))
    assert tl.dtype == torch.bfloat16
    _close(tl, jl)


@pytest.mark.parametrize("quant", [False, True], ids=["dense", "quantized"])
def test_f32_activations_match_jax_tightly(quant):
    """With f32 activations and caches in both packages the same algorithm
    agrees within ``F32_TOL`` of max |logit|: the forward on silence (no
    ``frontend_embeds``), a right-padded prefill and 4 decode steps."""
    jc, tc, jparams, tparams = _setup(quant)
    if quant:
        tc = tc.with_quant(impl="kernel")
    toks, _ = _inputs(9)
    lengths = np.array([5, 7], np.int32)
    nxt = np.random.default_rng(10).integers(0, jc.vocab, (2, 4)).astype(np.int32)
    with f32_activations(JE, TE):
        want = [jax.jit(lambda p, t: JE.forward(p, t, jc)[0])(jparams, jnp.asarray(toks))]
        lg, c = jax.jit(lambda p, t, c, n: JE.prefill(p, t, c, jc, lengths=n))(
            jparams, jnp.asarray(toks), JE.init_caches(jc, 2, 24, dtype=jnp.float32),
            jnp.asarray(lengths))
        want.append(lg)
        dec = jax.jit(lambda p, t, c: JE.decode_step(p, t, c, jc))
        for j in range(nxt.shape[1]):
            lg, c = dec(jparams, jnp.asarray(nxt[:, j:j + 1]), c)
            want.append(lg)
        got = [TE.forward(tparams, torch.from_numpy(toks), tc)[0]]
        lg, c = TE.prefill(tparams, torch.from_numpy(toks),
                           TE.init_caches(tc, 2, 24, torch.float32, device="cpu"), tc,
                           lengths=torch.from_numpy(lengths))
        got.append(lg)
        for j in range(nxt.shape[1]):
            lg, c = TE.decode_step(tparams, torch.from_numpy(nxt[:, j:j + 1]), c, tc)
            got.append(lg)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, F32_TOL)


def test_decode_position_clips_at_max_seq():
    """A slot past ``max_seq`` reads the last learned position, as JAX's
    ``clip`` does."""
    jc, tc, jparams, tparams = _setup(False)
    toks, _ = _inputs(11, S=3)
    jcache = JE.init_caches(jc, 2, 8)
    tcache = TE.init_caches(tc, 2, 8, device="cpu")
    far = np.array([jc.max_seq + 5, 2], np.int32)
    jcache["self"] = dataclasses.replace(
        jcache["self"], pos=jnp.broadcast_to(jnp.asarray(far)[None], jcache["self"].pos.shape))
    for layer in tcache:
        layer["self"].pos = torch.from_numpy(far.copy())
    jl, _ = jax.jit(lambda p, t, c: JE.decode_step(p, t, c, jc))(
        jparams, jnp.asarray(toks[:, :1]), jcache)
    tl, _ = TE.decode_step(tparams, torch.from_numpy(toks[:, :1]), tcache, tc)
    _close(tl, jl)


@pytest.mark.parametrize("smoke", [False, True])
def test_frontend_and_input_specs_match_jax(smoke):
    jc = jconfigs.get_config(ARCH, smoke=smoke)
    tc = tconfigs.get_config(ARCH, smoke=smoke)
    want, got = japi.frontend_spec(jc, 3), tapi.frontend_spec(tc, 3)
    assert got.device.type == "meta" and got.dtype == torch.bfloat16
    assert tuple(got.shape) == tuple(want.shape) == (3, 80, 2 * jc.frontend_tokens)
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        j = japi.input_specs(jc, jconfigs.get_shape(shape))
        t = tapi.input_specs(tc, tconfigs.get_shape(shape))
        assert set(t) == set(j)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape), (shape, k)
            assert str(t[k].dtype).split(".")[-1] == str(j[k].dtype), (shape, k)
        assert ("frontend_embeds" in t) == (shape != "decode_32k")
    assert tapi.cache_len(tc, tconfigs.get_shape("decode_32k")) == \
        japi.cache_len(jc, jconfigs.get_shape("decode_32k"))
