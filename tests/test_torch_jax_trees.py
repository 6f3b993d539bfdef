"""Where the port's per-layer trees meet the JAX package's stacked ones, on
the CPU.

* ``compress_grads``: JAX stacks a per-layer list's leaves on a leading
  axis, so one dictionary (one ``max |g|``) covers a path over all layers,
  and a layer's ``(D,)`` norm scale, ``(L, D)`` stacked, is compressed.
  The same gradient values through both packages give the same bin
  indices, on a dense (qwen3-32b) and a MoE (deepseek-moe-16b, whose
  ``dense_layers`` are a list in JAX too) smoke tree at 16 and 256 bins;
  and one ``compress_grads_bins`` train step moves the moments as JAX's.
* Microbatch gradients are summed in f32, as JAX's step does from f32
  zeros: under bf16 params the grads are f32 and equal the f32 sum of the
  port's own per-microbatch grads.
* ``interop`` carries a bf16 JAX params tree and optimizer state bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import f32_activations, jax_flat, port_flat, port_params, tree_to_numpy

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import transformer as JT
from repro.models.common import ShardCtx as JShardCtx
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as opt
from repro_torch.train import step as tstep


def _grad_like(jparams, seed):
    """Seeded gradient values shaped as the JAX params' float leaves, each
    stacked leaf's layers at scales 1, 3, 0.5, ... so that one layer's
    ``max |g|`` is not another's."""
    rng = np.random.default_rng(seed)

    def one(x):
        g = rng.standard_normal(x.shape).astype(np.float32)
        if x.ndim >= 2:
            g *= np.resize(np.array([1.0, 3.0, 0.5, 2.0], np.float32), x.shape[0]).reshape(
                (-1,) + (1,) * (x.ndim - 1))
        return g

    return jax.tree.map(lambda x: jnp.asarray(one(x)), jparams)


def _indices(flat, jgrads, bins):
    """Each compressed leaf's bin indices, on the JAX leaf's dictionary."""
    out = {}
    for k, g in flat.items():
        w = jgrads[k]
        if w.ndim < 2:
            continue
        step = (np.abs(w).max() + 1e-12) / (bins / 2 - 1)
        out[k] = np.rint(np.asarray(g, np.float64) / step).astype(np.int64)
    return out


@pytest.mark.parametrize("bins", [16, 256])
@pytest.mark.parametrize("arch", ["qwen3-32b", "deepseek-moe-16b"])
def test_compress_grads_one_dictionary_per_stacked_leaf(arch, bins):
    jcfg = jget_config(arch, smoke=True)
    jparams = japi.get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    jg = _grad_like(jparams, 1)
    want = jax_flat(jopt.compress_grads(jg, bins))
    got = port_flat(opt.compress_grads(port_params(jg), bins))
    jgf = jax_flat(jg)
    assert set(got) == set(want)
    assert any(jgf[k].ndim == 2 and "norm" in k for k in want)  # stacked (L, D) scales
    wi, gi = _indices(want, jgf, bins), _indices(got, jgf, bins)
    for k in want:
        if k in wi:
            np.testing.assert_array_equal(gi[k], wi[k], err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:  # not compressed: the values pass through
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_compress_grads_train_step_matches_jax():
    """One qwen3-32b smoke step with ``compress_grads_bins=16``, f32
    activations in both packages (the same algorithm without bf16
    rounding): the first moments, ``(1 - b1)`` times the compressed
    gradient, agree within f32 noise wherever JAX's gradient does not lie
    within 1e-3 of a bin's edge (where f32 noise may pick the other bin)."""
    bins = 16
    jcfg, tcfg = jget_config("qwen3-32b", smoke=True), get_config("qwen3-32b", smoke=True)
    jparams = japi.get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0))
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=20)
    jo, to = jopt.AdamWConfig(**ocfg), opt.AdamWConfig(**ocfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (2, 17)).astype(np.int32)
    model = japi.get_model(jcfg)

    def jax_step(params, state, batch):
        (loss, _), grads = jax.value_and_grad(jstep._loss_fn, has_aux=True)(
            params, batch, jcfg, JShardCtx(), model, None)
        p, s, _ = jstep._guarded_update(params, state, loss,
                                        jopt.compress_grads(grads, bins), jo, guard=True)
        return s, grads

    with f32_activations(JT, TT):
        jstate, jgrads = jax.jit(jax_step)(
            jparams, jopt.init_opt_state(jparams),
            {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])})
        tparams = port_params(jparams)
        _, tstate, m = tstep.make_train_step(tcfg, to, compress_grads_bins=bins)(
            tparams, opt.init_opt_state(tparams),
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(toks[:, 1:]).long()})
    assert int(m["skipped"]) == 0
    want, got, jg = jax_flat(jstate.mu), port_flat(tstate.mu), jax_flat(jgrads)
    n_masked = 0
    for k, w in want.items():
        g = jg[k]
        if g.ndim >= 2:
            u = np.abs(g) / (np.abs(g).max() + 1e-12) * (bins / 2 - 1)
            ok = np.abs(u - np.floor(u) - 0.5) > 1e-3
        else:
            ok = np.ones(g.shape, bool)
        n_masked += int((~ok).sum())
        np.testing.assert_allclose(got[k][ok], w[ok], rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()), err_msg=k)
    assert n_masked < 1e-2 * sum(w.size for w in want.values())  # about 2e-3 expected


def test_microbatch_grads_accumulate_in_f32():
    cfg = get_config("qwen3-32b", smoke=True)
    params = TT.init_params(cfg, torch.Generator().manual_seed(1), dtype=torch.bfloat16)
    batch = tpipe.synthetic_batch(tpipe.DataConfig(seed=5, vocab=cfg.vocab, seq_len=16,
                                                   global_batch=8), 0, device="cpu")
    n = 4
    loss, _, grads = tstep.loss_and_grads(params, batch, cfg, microbatches=n)
    parts = [tstep.loss_and_grads(params, {k: v[2 * i:2 * i + 2] for k, v in batch.items()},
                                  cfg)[2] for i in range(n)]
    got, each = port_flat(grads), [port_flat(p) for p in parts]
    for k, g in got.items():
        if each[0][k].dtype == np.uint8:
            continue
        want = each[0][k].astype(np.float32)
        for e in each[1:]:
            want = want + e[k].astype(np.float32)
        np.testing.assert_array_equal(g, want / n, err_msg=k)
    for path_leaf in grads["layers"][0]["attn"].values():
        if isinstance(path_leaf, torch.Tensor):
            assert path_leaf.dtype == torch.float32
    assert grads["embed"].dtype == torch.float32 and params["embed"].dtype == torch.bfloat16


def test_interop_carries_bf16_trees_bitwise():
    jcfg = jget_config("qwen3-32b", smoke=True)
    jparams = japi.get_model(jcfg).init_params(jcfg, jax.random.PRNGKey(0),
                                                dtype=jnp.bfloat16)
    tparams = port_params(jparams)
    want, got = jax_flat(jparams), port_flat(tparams)
    assert tparams["embed"].dtype == torch.bfloat16
    assert set(got) == set(want)
    for k, w in want.items():
        assert w.dtype.name == "bfloat16", k
        np.testing.assert_array_equal(got[k].view(np.uint32),
                                      w.astype(np.float32).view(np.uint32), err_msg=k)
    js = jopt.init_opt_state(jparams)
    half = jax.tree.map(lambda x: (x * 0.5).astype(jnp.bfloat16), jparams)
    ts = interop.opt_state_from_numpy(
        {"step": np.asarray(js.step), "mu": tree_to_numpy(half), "nu": tree_to_numpy(js.nu)},
        interop.lm_params_from_numpy, device="cpu")
    assert ts.mu["embed"].dtype == torch.bfloat16 and ts.nu["embed"].dtype == torch.float32
    for k, w in jax_flat(half).items():
        np.testing.assert_array_equal(port_flat(ts.mu)[k].view(np.uint32),
                                      w.astype(np.float32).view(np.uint32), err_msg=k)
