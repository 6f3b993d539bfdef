"""The port's LM training path and its infrastructure against the JAX package,
on the CPU.

* The optimizer: ``adamw_update``, ``cosine_lr``, ``global_norm``,
  ``compress_grads`` and ``nonfinite_probe`` on the same trees.
* One train step on the qwen3-32b smoke config from the same params,
  optimizer state and batch, ``dense`` and ``pasm`` (``impl="kernel"``,
  the layers quantized; K1's plain version here): loss, grads and the
  updated state, then a 3-step loss trajectory.  The JAX package's
  ``make_train_step`` cannot differentiate a tree with uint8 indices
  (``jax.value_and_grad`` without ``allow_int``), so its side is built
  from the same pieces with ``allow_int=True`` (ROADMAP Queue 3).
  Tolerance: the activations are bf16 in both, every linear output and
  every backward op's output rounded to bf16 (XLA keeps some fused
  intermediates in f32), so differences of a few bf16 ulps (2^-8
  relative) build up through the layers: ``|Δ| <= 2.5e-2·max|jax|`` on
  each grad and moment leaf (PERF.md's LM logit tolerance; measured
  ≤ 1.2e-2), the first loss within ``1e-3``.  AdamW's first steps move a
  weight by about ``±lr`` whatever its gradient's size, so a weight whose
  gradient lies within that tolerance of zero may move the other way in
  one package: the 3-step trajectory is held within ``1e-2``.
* ``cfg.remat``: the layer body reruns in the backward, K1 included.
* The data pipeline, checkpoints and ``ft`` (the cases of
  ``tests/test_infra.py``), and the launcher's CPU smoke run.
"""
import contextlib
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import (assert_update_close, f32_activations, jax_flat, port_flat, port_params,
                       tree_to_numpy)

from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import api as japi
from repro.models.common import ShardCtx as JShardCtx
from repro.models.common import quantize_params as jquantize
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import ft, interop
from repro_torch.ckpt import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.data.pipeline import DataConfig, DataValidationError
from repro_torch.kernels import ops as tops
from repro_torch.launch import train as tlaunch
from repro_torch.models import api as tapi
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep
from repro_torch.tree import tree_leaves

OCFG = dict(lr=1e-2, warmup_steps=1, total_steps=20)
LM_TOL = 2.5e-2


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    p = {"w": rng.standard_normal((6, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32),
         "idx": rng.integers(0, 16, (6, 4)).astype(np.uint8)}
    gs = [{"w": rng.standard_normal((6, 4)).astype(np.float32) * s,
           "b": rng.standard_normal(4).astype(np.float32) * s}
          for s in (0.1, 3.0, 0.5)]
    return p, gs


def test_adamw_update_matches_jax():
    """Three steps (the second clipped) on a tree with an integer leaf."""
    p, gs = _opt_trees()
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    js, ts = jopt.init_opt_state(jp), opt.init_opt_state(tp)
    jc, tc = jopt.AdamWConfig(**OCFG), opt.AdamWConfig(**OCFG)
    for g in gs:
        jg = dict({k: jnp.asarray(v) for k, v in g.items()},
                  idx=jnp.zeros((6, 4), jnp.uint8))
        jp, js, jm = jopt.adamw_update(jp, jg, js, jc)
        tg = dict({k: _t(v) for k, v in g.items()}, idx=None)  # no grad
        tp, ts, tm = opt.adamw_update(tp, tg, ts, tc)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(js.nu[k]), rtol=1e-6)
        np.testing.assert_array_equal(tp["idx"].numpy(), p["idx"])  # frozen
        assert ts.mu["idx"].shape == () and int(ts.step) == int(js.step)


def test_cosine_lr_and_global_norm_match_jax():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jc, tc = jopt.AdamWConfig(**cfg), opt.AdamWConfig(**cfg)
    for s in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(
            float(opt.cosine_lr(tc, torch.tensor(s, dtype=torch.int32))),
            float(jopt.cosine_lr(jc, jnp.asarray(s, jnp.int32))), rtol=1e-6, atol=1e-7)
    p, gs = _opt_trees(1)
    np.testing.assert_allclose(
        float(opt.global_norm({k: _t(v) for k, v in gs[1].items()})),
        float(jopt.global_norm({k: jnp.asarray(v) for k, v in gs[1].items()})), rtol=1e-6)


def test_compress_grads_matches_jax_and_bound():
    g = np.random.default_rng(2).standard_normal((64, 64)).astype(np.float32)
    for bins in (16, 256):
        got = opt.compress_grads({"w": _t(g), "b": _t(g[0])}, bins)
        want = jopt.compress_grads({"w": jnp.asarray(g), "b": jnp.asarray(g[0])}, bins)
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=1e-6,
                                   atol=1e-7)
        assert torch.equal(got["b"], _t(g[0]))  # vectors pass through
        width = np.abs(g).max() / (bins / 2 - 1)
        assert np.abs(got["w"].numpy() - g).max() <= width * 0.51


@pytest.mark.parametrize("bad", [None, "nan", "inf", "loss"])
def test_nonfinite_probe_matches_jax(bad):
    g = np.ones((3, 4), np.float32)
    loss = np.float32(1.5)
    if bad in ("nan", "inf"):
        g[1, 2] = float(bad)
    if bad == "loss":
        loss = np.float32("nan")
    want = bool(jopt.nonfinite_probe(jnp.asarray(loss), {"g": jnp.asarray(g)}))
    got = opt.nonfinite_probe(_t(loss), {"g": _t(g), "idx": torch.zeros(2, dtype=torch.uint8)})
    assert got.dtype == torch.bool and bool(got) == want == (bad is None)


def test_tree_select_keeps_old_bits():
    a = {"w": torch.randn(5), "i": torch.arange(5, dtype=torch.uint8)}
    b = {"w": torch.full((5,), float("nan")), "i": torch.zeros(5, dtype=torch.uint8)}
    out = opt.tree_select(torch.tensor(False), b, a)
    assert torch.equal(out["w"].view(torch.int32), a["w"].view(torch.int32))
    assert torch.equal(out["i"], a["i"])


# ---------------------------------------------------------------------------
# the LM train step, port vs JAX
# ---------------------------------------------------------------------------


def _jax_step(cfg, ocfg):
    """The JAX package's ``make_train_step`` body, differentiated with
    ``allow_int=True`` so a quantized tree (uint8 indices) passes."""
    model = japi.get_model(cfg)

    def step(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(jstep._loss_fn, has_aux=True,
                                              allow_int=True)(
            params, batch, cfg, JShardCtx(), model, None)
        params, opt_state, m = jstep._guarded_update(params, opt_state, loss, grads,
                                                     ocfg, guard=True)
        return params, opt_state, dict(m, loss=loss), grads

    return jax.jit(step)


@pytest.fixture(scope="module", params=["dense", "pasm"])
def lm_pair(request):
    jcfg = jget_config("qwen3-32b", smoke=True)
    tcfg = get_config("qwen3-32b", smoke=True)
    if request.param == "pasm":
        q = dict(enabled=True, impl="kernel", min_weight_elems=1024)
        jcfg, tcfg = jcfg.with_quant(**q), tcfg.with_quant(**q)
    jparams = japi.get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    if request.param == "pasm":
        jparams = jquantize(jparams, jcfg)
    toks = np.asarray(jpipe.synthetic_batch(
        jpipe.DataConfig(seed=3, vocab=jcfg.vocab, seq_len=16, global_batch=2), 0)["tokens"])
    return request.param, jcfg, tcfg, jparams, toks


def _batches(toks, n):
    """``n`` step batches: the token window shifted by one per step."""
    return [(np.roll(toks, s, axis=1)[:, :-1], np.roll(toks, s, axis=1)[:, 1:])
            for s in range(n)]


def test_lm_train_step_matches_jax(lm_pair):
    kind, jcfg, tcfg, jparams, toks = lm_pair
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), opt.AdamWConfig(**OCFG)
    tparams = port_params(jparams)
    if kind == "pasm":  # the layers' seven linears and the head are weight-shared
        assert sum(hasattr(x, "idx") and x.idx is not None
                   for x in tparams["layers"][0]["attn"].values()) == 4
    js = jopt.init_opt_state(jparams)
    ts = interop.opt_state_from_numpy(
        {"step": np.asarray(js.step), "mu": tree_to_numpy(js.mu),
         "nu": tree_to_numpy(js.nu)}, interop.lm_params_from_numpy, device="cpu")
    step_j = _jax_step(jcfg, ocfg_j)
    step_t = tstep.make_train_step(tcfg, ocfg_t)
    jl, tl = [], []
    jstate, tstate = (jparams, js), (tparams, ts)
    for i, (x, y) in enumerate(_batches(toks, 3)):
        jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        tb = {"tokens": _t(x), "labels": _t(y)}
        if i == 0:
            loss, _, grads = tstep.loss_and_grads(tstate[0], tb, tcfg)
            *_, jgrads = step_j(*jstate, jb)
            got, want = port_flat(grads), jax_flat(jgrads)
            assert set(got) == {k for k in want if not k.endswith("/idx")}
            for k, g in got.items():
                np.testing.assert_allclose(
                    g, want[k], rtol=0, atol=LM_TOL * float(np.abs(want[k]).max()),
                    err_msg=k)
        jp, jo, jm, _ = step_j(*jstate, jb)
        tp, to, tm = step_t(*tstate, tb)
        assert int(tm["skipped"]) == int(jm["skipped"]) == 0
        if i == 0:
            assert_update_close((tp, to), (jp, jo), LM_TOL, g_floor=2 * LM_TOL)
        jstate, tstate = (jp, jo), (tp, to)
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-3)
    np.testing.assert_allclose(tl, jl, rtol=1e-2)
    assert tl[-1] < tl[0]


def test_moe_train_step_matches_jax():
    """One deepseek-moe-16b smoke train step (the layers and experts
    weight-shared, one dictionary set per expert; K1's plain version) from
    the same state as the JAX step on ``dequant``: the loss carries the MoE
    balance term, ``0.01·moe_load_balance / n_layers``, and the router gets
    its gradient through the gates and that term; loss, grads and the
    update within the LM tolerance."""
    q = dict(enabled=True, min_weight_elems=1024)
    jcfg = jget_config("deepseek-moe-16b", smoke=True).with_quant(impl="dequant", **q)
    tcfg = get_config("deepseek-moe-16b", smoke=True).with_quant(impl="kernel", **q)
    jparams = jax.jit(lambda k: jquantize(japi.get_model(jcfg).init_params(jcfg, k), jcfg))(
        jax.random.PRNGKey(0))
    tparams = port_params(jparams)
    assert tparams["layers"][0]["moe"]["w1"].idx.shape[0] == tcfg.moe.n_experts
    toks = np.asarray(jpipe.synthetic_batch(
        jpipe.DataConfig(seed=3, vocab=jcfg.vocab, seq_len=16, global_batch=2), 0)["tokens"])
    (x, y), = _batches(toks, 1)
    js = jopt.init_opt_state(jparams)
    ts = interop.opt_state_from_numpy(
        {"step": np.asarray(js.step), "mu": tree_to_numpy(js.mu),
         "nu": tree_to_numpy(js.nu)}, interop.lm_params_from_numpy, device="cpu")
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), opt.AdamWConfig(**OCFG)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"tokens": _t(x), "labels": _t(y)}
    jp, jo, jm, jgrads = _jax_step(jcfg, ocfg_j)(jparams, js, jb)
    loss, aux, grads = tstep.loss_and_grads(tparams, tb, tcfg)
    _, jaux = jstep._loss_fn(jparams, jb, jcfg, JShardCtx(), japi.get_model(jcfg))
    np.testing.assert_allclose(float(aux["moe_load_balance"]),
                               float(jaux["moe_load_balance"]), rtol=1e-2)
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-3)
    got, want = port_flat(grads), jax_flat(jgrads)
    assert set(got) == {k for k in want if not k.endswith("/idx")}
    assert float(np.abs(got["layers/moe/router"]).max()) > 0
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=LM_TOL * float(np.abs(want[k]).max()), err_msg=k)
    tp, to, tm = tstep.make_train_step(tcfg, ocfg_t)(tparams, ts, tb)
    assert int(tm["skipped"]) == int(jm["skipped"]) == 0
    # nu = (1 - b2)·g² doubles g's relative error (measured: grads within
    # 1.9e-2 of max here, the router and the codebooks the largest)
    assert_update_close((tp, to), (jp, jo), 2 * LM_TOL, g_floor=4 * LM_TOL)


def _undo_stacked_decay(new, old, lr: float, wd: float):
    """The JAX update with the weight decay taken back off its stacked
    per-layer vectors (``(L, D)`` leaves under ``layers``/``groups``): the
    port's per-layer leaf is ``(D,)``, which AdamW does not decay (ROADMAP
    Queue 3).  The decoupled decay moved such a leaf by ``-lr·wd·p``."""
    def fix(path, n, o):
        keys = {getattr(k, "key", None) for k in path}
        if keys & {"layers", "groups", "enc_layers", "dec_layers"} and \
                getattr(n, "ndim", 0) == 2 and \
                jnp.issubdtype(n.dtype, jnp.floating):
            return n + lr * wd * o
        return n

    return jax.tree_util.tree_map_with_path(fix, new, old)


# the hybrid's bf16 grads: JAX's own move by up to 13.5 % of a leaf's max
# when its embeddings move by one bf16 ulp (its RG-LRU gates amplify the
# noise; the SSM's 2.1 %), so they are held loosely in bf16 and tightly
# with f32 activations in both packages
HYBRID_GRAD_TOL = 0.25
F32_GRAD_TOL = 1e-3


@pytest.mark.parametrize("arch", ["mamba2-130m", "recurrentgemma-2b"])
def test_recurrent_train_step_matches_jax(arch):
    """One train step of the SSM and hybrid families (the hybrid at 8
    layers: two scanned groups, restacked leaf by leaf by ``port_flat``,
    and the recurrent tail), weight-shared, on K1's plain version, from the
    same state as the JAX step on ``dequant``: the loss, the grads and the
    update.  The SSM within the LM tolerance; the hybrid's loss within
    1e-3 and its grads within ``HYBRID_GRAD_TOL`` in bf16, and its grads
    and update within ``F32_GRAD_TOL`` with f32 activations."""
    q = dict(enabled=True, min_weight_elems=1024)
    jcfg = jget_config(arch, smoke=True).with_quant(impl="dequant", **q)
    tcfg = get_config(arch, smoke=True).with_quant(impl="kernel", **q)
    hybrid = arch == "recurrentgemma-2b"
    if hybrid:
        jcfg, tcfg = (dataclasses.replace(c, n_layers=8) for c in (jcfg, tcfg))
    jmodel, tmodel = japi.get_model(jcfg), tapi.get_model(tcfg)
    jparams = jax.jit(lambda k: jquantize(jmodel.init_params(jcfg, k), jcfg))(
        jax.random.PRNGKey(0))
    tparams = port_params(jparams)
    toks = np.asarray(jpipe.synthetic_batch(
        jpipe.DataConfig(seed=3, vocab=jcfg.vocab, seq_len=16, global_batch=2), 0)["tokens"])
    (x, y), = _batches(toks, 1)
    js = jopt.init_opt_state(jparams)
    ts = interop.opt_state_from_numpy(
        {"step": np.asarray(js.step), "mu": tree_to_numpy(js.mu),
         "nu": tree_to_numpy(js.nu)}, interop.lm_params_from_numpy, device="cpu")
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), opt.AdamWConfig(**OCFG)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"tokens": _t(x), "labels": _t(y)}
    for f32 in ((False, True) if hybrid else (False,)):
        ctx = f32_activations(jmodel, tmodel) if f32 else contextlib.nullcontext()
        with ctx:
            jp, jo, jm, jgrads = _jax_step(jcfg, ocfg_j)(jparams, js, jb)
            loss, aux, grads = tstep.loss_and_grads(tparams, tb, tcfg)
            tp, to, tm = tstep.make_train_step(tcfg, ocfg_t)(tparams, ts, tb)
        assert aux == {} and int(tm["skipped"]) == int(jm["skipped"]) == 0
        np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-3)
        got, want = port_flat(grads), jax_flat(jgrads)
        assert set(got) == {k for k in want if not k.endswith("/idx")}
        if hybrid:
            assert got["groups/l2/attn/wq/codebook"].shape[0] == 2
        tol = F32_GRAD_TOL if f32 else HYBRID_GRAD_TOL if hybrid else LM_TOL
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k], rtol=0,
                                       atol=tol * float(np.abs(want[k]).max()), err_msg=k)
        if f32 or not hybrid:
            jp = _undo_stacked_decay(jp, jparams, float(jm["lr"]), ocfg_j.weight_decay)
            assert_update_close((tp, to), (jp, jo), 2 * tol, g_floor=4 * tol)


def test_encdec_train_step_matches_jax():
    """One whisper-tiny smoke train step (the encoder's and decoder's
    linears weight-shared on K1's plain version, the mel stem dense and
    trained; the batch carries no mel, so both encode silence) from the
    same state as the JAX step on ``dequant``: the loss within 1e-3, every
    grad and the update within the LM tolerance — the stem's and the
    encoder's included, which reach the loss only through the
    cross-attention."""
    q = dict(enabled=True, min_weight_elems=1024)
    jcfg = jget_config("whisper-tiny", smoke=True).with_quant(impl="dequant", **q)
    tcfg = get_config("whisper-tiny", smoke=True).with_quant(impl="kernel", **q)
    jmodel = japi.get_model(jcfg)
    jparams = jax.jit(lambda k: jquantize(jmodel.init_params(jcfg, k), jcfg))(
        jax.random.PRNGKey(0))
    tparams = port_params(jparams)
    assert tparams["enc_layers"][0]["mlp"]["w1"].idx is not None
    toks = np.asarray(jpipe.synthetic_batch(
        jpipe.DataConfig(seed=3, vocab=jcfg.vocab, seq_len=16, global_batch=2), 0)["tokens"])
    (x, y), = _batches(toks, 1)
    js = jopt.init_opt_state(jparams)
    ts = interop.opt_state_from_numpy(
        {"step": np.asarray(js.step), "mu": tree_to_numpy(js.mu),
         "nu": tree_to_numpy(js.nu)}, interop.lm_params_from_numpy, device="cpu")
    ocfg_j, ocfg_t = jopt.AdamWConfig(**OCFG), opt.AdamWConfig(**OCFG)
    jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    tb = {"tokens": _t(x), "labels": _t(y)}
    jp, jo, jm, jgrads = _jax_step(jcfg, ocfg_j)(jparams, js, jb)
    loss, aux, grads = tstep.loss_and_grads(tparams, tb, tcfg)
    tp, to, tm = tstep.make_train_step(tcfg, ocfg_t)(tparams, ts, tb)
    assert aux == {} and int(tm["skipped"]) == int(jm["skipped"]) == 0
    np.testing.assert_allclose(float(loss), float(jm["loss"]), rtol=1e-3)
    got, want = port_flat(grads), jax_flat(jgrads)
    assert set(got) == {k for k in want if not k.endswith("/idx")}
    # silence zeroes the stem's inputs, so its kernels get no gradient and
    # its biases all of it, through the encoder and the cross-attention
    assert float(np.abs(got["frontend/conv1/kernel"]).max()) == 0
    assert float(np.abs(got["frontend/conv1/bias"]).max()) > 0
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=0,
                                   atol=LM_TOL * float(np.abs(want[k]).max()), err_msg=k)
    jp = _undo_stacked_decay(jp, jparams, float(jm["lr"]), ocfg_j.weight_decay)
    assert_update_close((tp, to), (jp, jo), 2 * LM_TOL, g_floor=4 * LM_TOL)


def test_remat_reruns_each_layer_in_the_backward(monkeypatch):
    """``cfg.remat``: a step calls K1 7 times a layer + the head in the
    forward and again 7 times a layer in the backward; without remat only
    the forward's.  Equal losses and grads either way."""
    cfg = get_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="kernel", min_weight_elems=1024)
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params

    params = quantize_params(TT.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    batch = tpipe.synthetic_batch(DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2),
                                  0, device="cpu")
    calls = {"n": 0}
    k1 = tops.pasm_matmul_kernel_call

    def counted(*a, **kw):
        calls["n"] += 1
        return k1(*a, **kw)

    monkeypatch.setattr(tops, "pasm_matmul_kernel_call", counted)
    out = {}
    L = cfg.n_layers
    for remat, want in ((False, 7 * L + 1), (True, 7 * L + 1 + 7 * L)):
        calls["n"] = 0
        out[remat] = tstep.loss_and_grads(params, batch,
                                          dataclasses.replace(cfg, remat=remat))
        assert calls["n"] == want, (remat, calls["n"])
    assert torch.equal(out[True][0], out[False][0])
    for a, b in zip(tree_leaves(out[True][2]), tree_leaves(out[False][2])):
        assert torch.equal(a, b)


def test_microbatches_match_full_batch():
    cfg = get_config("qwen3-32b", smoke=True)
    from repro_torch.models import transformer as TT

    params = TT.init_params(cfg, torch.Generator().manual_seed(1))
    state = opt.init_opt_state(params)
    batch = tpipe.synthetic_batch(DataConfig(seed=5, vocab=cfg.vocab, seq_len=16,
                                             global_batch=4), 0, device="cpu")
    ocfg = opt.AdamWConfig(lr=1e-3)
    p1, _, m1 = tstep.make_train_step(cfg, ocfg)(params, state, batch)
    p2, _, m2 = tstep.make_train_step(cfg, ocfg, microbatches=2)(params, state, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-3)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_launcher_smoke_run_on_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch qwen3-32b --smoke --quant
    pasm --steps 6 --device cpu``, with checkpoints, then a resumed run."""
    argv = ["--arch", "qwen3-32b", "--smoke", "--quant", "pasm", "--steps", "6",
            "--device", "cpu", "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    assert tlaunch.main(argv) == 6
    assert ck.complete_steps(tmp_path) == [2, 4, 6]
    resume = [("8" if a == "6" else a) for a in argv] + ["--resume", "auto"]
    assert tlaunch.main(resume) == 8
    out = capsys.readouterr().out
    assert "resumed from step 6" in out and "done at step 8" in out


# ---------------------------------------------------------------------------
# data pipeline (tests/test_infra.py's cases)
# ---------------------------------------------------------------------------


def test_synthetic_stream_is_step_addressed():
    cfg = DataConfig(seed=1, vocab=1000, seq_len=32, global_batch=4)
    a = tpipe.synthetic_batch(cfg, 7, device="cpu")
    assert torch.equal(a["tokens"], tpipe.synthetic_batch(cfg, 7, device="cpu")["tokens"])
    assert not torch.equal(a["tokens"], tpipe.synthetic_batch(cfg, 8, device="cpu")["tokens"])
    assert a["tokens"].dtype == torch.int32 and int(a["tokens"].max()) < 1000
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])  # shifted labels
    base = dict(seed=1, vocab=1000, seq_len=16, global_batch=8, n_shards=2)
    s0 = tpipe.synthetic_batch(DataConfig(**base, shard_index=0), 3, device="cpu")
    s1 = tpipe.synthetic_batch(DataConfig(**base, shard_index=1), 3, device="cpu")
    assert s0["tokens"].shape == (4, 16)
    assert not torch.equal(s0["tokens"], s1["tokens"])
    it = tpipe.batch_iterator(cfg, start_step=7, device="cpu")
    assert torch.equal(next(it)["tokens"], a["tokens"])
    im = tpipe.synthetic_image_batch(cfg, 2, chw=(1, 8, 8), classes=4, device="cpu")
    assert im["images"].shape == (4, 1, 8, 8) and int(im["labels"].max()) < 4
    assert torch.equal(im["images"], tpipe.synthetic_image_batch(
        cfg, 2, chw=(1, 8, 8), classes=4, device="cpu")["images"])


def test_token_file_reads_the_jax_packages_bytes(tmp_path):
    path = tmp_path / "tokens.bin"
    tpipe.write_token_file(str(path), np.arange(17 * 10, dtype=np.uint32))
    cfg = dict(seed=0, vocab=200, seq_len=16, global_batch=2, path=str(path))
    ds = tpipe.TokenFileDataset(DataConfig(**cfg), device="cpu")
    jds = jpipe.TokenFileDataset(jpipe.DataConfig(**cfg))
    assert ds.n_seqs == 10
    for step in (0, 3):
        b, jb = ds.batch(step), jds.batch(step)
        np.testing.assert_array_equal(b["tokens"].numpy(), np.asarray(jb["tokens"]))
        np.testing.assert_array_equal(b["labels"].numpy(), np.asarray(jb["labels"]))


def test_data_validation_and_retry(tmp_path):
    with pytest.raises(DataValidationError, match="divide evenly"):
        DataConfig(global_batch=7, n_shards=2)
    with pytest.raises(DataValidationError, match="shard_index"):
        DataConfig(global_batch=8, n_shards=2, shard_index=2)
    with pytest.raises(DataValidationError):
        DataConfig(global_batch=0)
    tiny = tmp_path / "tiny.bin"
    tpipe.write_token_file(str(tiny), np.arange(10, dtype=np.uint32))
    with pytest.raises(DataValidationError, match="empty/truncated"):
        tpipe.TokenFileDataset(DataConfig(seq_len=16, global_batch=2, path=str(tiny)),
                               device="cpu")
    with pytest.raises(DataValidationError, match="cfg.path"):
        tpipe.TokenFileDataset(DataConfig(seq_len=16, global_batch=2), device="cpu")
    path = tmp_path / "tokens.bin"
    tpipe.write_token_file(str(path), np.arange(17 * 4, dtype=np.uint32))
    cfg = DataConfig(seed=0, vocab=200, seq_len=16, global_batch=2, path=str(path))
    fails = {"n": 2}

    def hook(step):
        if fails["n"]:
            fails["n"] -= 1
            raise OSError("flaky mount")

    delays = []
    ds = tpipe.TokenFileDataset(cfg, backoff_s=0.05, cap_s=0.08, sleep=delays.append,
                                fault_hook=hook, device="cpu")
    with pytest.warns(RuntimeWarning, match="transient I/O"):
        b = ds.batch(0)
    assert delays == [0.05, 0.08]  # doubled then capped, zero wall clock
    assert torch.equal(b["tokens"], tpipe.TokenFileDataset(cfg, device="cpu").batch(0)["tokens"])


# ---------------------------------------------------------------------------
# checkpoints (tests/test_infra.py's cases)
# ---------------------------------------------------------------------------


def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16),
                       "step": torch.tensor(7)}}


def test_checkpoint_roundtrip_layout_and_crc(tmp_path):
    import json

    t = _tree()
    ck.save(tmp_path, 10, t, extra={"note": "x"})
    man = json.loads((tmp_path / "step_10" / "manifest.json").read_text())
    assert man["keys"] == ["a", "nested||b", "nested||step"] and len(man["crc32"]) == 3
    assert (tmp_path / "step_10" / "shard_0.npz").exists()
    restored, manifest = ck.restore(tmp_path, t)
    assert manifest["step"] == 10 and manifest["extra"]["note"] == "x"
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_of_params_and_opt_state(tmp_path):
    """A quantized LM tree with its AdamW state round-trips bitwise."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.common import quantize_params

    cfg = get_config("qwen3-32b", smoke=True).with_quant(enabled=True,
                                                        min_weight_elems=1024)
    params = quantize_params(TT.init_params(cfg, torch.Generator().manual_seed(0)), cfg)
    state = (params, opt.init_opt_state(params))
    ck.save(tmp_path, 1, state)
    restored, _ = ck.restore(tmp_path, state)
    assert type(restored[1]) is opt.OptState
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_latest_gc_mismatch_and_incomplete(tmp_path):
    mgr = ck.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    mgr.wait()
    mgr._gc()
    assert ck.latest_step(tmp_path) == 4
    assert ck.complete_steps(tmp_path) == [3, 4]  # keep-last-2
    (tmp_path / "step_9").mkdir()  # a crash mid-write: no manifest
    assert ck.latest_step(tmp_path) == 4
    bad = {"a": torch.zeros(3, 3), "nested": {"b": torch.ones(4), "step": torch.tensor(0)}}
    with pytest.raises(ValueError):
        ck.restore(tmp_path, bad)


def test_background_save_failure_surfaces(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("I am a file, not a directory")
    bad_dir = blocker / "ckpts"
    writer = ck.save(bad_dir, 1, _tree(), background=True)
    writer.join()
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        writer.check()
    writer.check()  # reported once
    mgr = ck.CheckpointManager(bad_dir)
    mgr.save(1, _tree())
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        mgr.save(2, _tree())
    mgr.wait()
    good = ck.CheckpointManager(tmp_path / "ok")
    good.save(3, _tree())
    good.wait()
    restored, manifest = good.restore_latest(_tree())
    assert manifest["step"] == 3 and torch.equal(restored["a"], _tree()["a"])


def test_gc_never_deletes_pending_inflight_write(tmp_path, monkeypatch):
    mgr = ck.CheckpointManager(tmp_path, keep=2)
    for s in (10, 20, 30):
        ck.save(tmp_path, s, _tree())
    orig_save = ck.save

    def landed_before_gc(directory, step, tree, *, extra=None, background=False):
        orig_save(directory, step, tree, extra=extra, background=False)
        done = ck.BackgroundWriter(lambda: None)
        done.start()
        return done

    monkeypatch.setattr(ck, "save", landed_before_gc)
    mgr.save(4, _tree())  # the post-fallback re-save: older than 10/20/30
    mgr.wait()
    assert (tmp_path / "step_4").exists(), "gc deleted the in-flight checkpoint"
    assert {4, 30} <= set(ck.complete_steps(tmp_path))
    mgr.save(40, _tree())
    mgr.wait()
    mgr._gc()
    assert 4 not in ck.complete_steps(tmp_path)


# ---------------------------------------------------------------------------
# ft (tests/test_infra.py's cases)
# ---------------------------------------------------------------------------


def test_straggler_detection():
    det = ft.StragglerDetector(n_hosts=4, window=10, threshold=1.5)
    for _ in range(10):
        for h in range(4):
            det.record(h, 1.0 if h != 2 else 3.0)
    assert det.stragglers() == [2]


def test_supervisor_restarts_then_succeeds_or_gives_up():
    calls = []

    def flaky(resume):
        calls.append(resume)
        if len(calls) < 3:
            raise RuntimeError("chip fell off")
        return 42

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=5, backoff_s=0.0),
                        sleep=lambda s: None)
    assert sup.run(flaky) == 42 and sup.restarts == 2

    def always_fails(resume):
        raise RuntimeError("dead host")

    sup = ft.Supervisor(ft.RestartPolicy(max_restarts=2, backoff_s=0.0),
                        sleep=lambda s: None)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="exceeded max_restarts"):
        sup.run(always_fails)
    assert time.perf_counter() - t0 < 1.0  # injected sleep: zero wall clock
