"""Sharded training against one device and against the JAX package, on the CPU.

The CNN QAT step (``make_cnn_train_step(mesh=)``) and the dense LM's train
step (``make_train_step`` under an active ``ShardCtx``) run SPMD, one gloo
process a rank over a ``file://`` store, one ``torch.multiprocessing``
spawn a mesh shape: ``(2, 2)``, ``(2, 1)``, ``(1, 2)``
(``tests/_torch_train_sharding_worker.py``).  Each rank holds against the
port's one-device step, in its own process:

- the loss and every gradient leaf (gathered with ``gather_params``), and
  the updated tree, within the tolerances the worker states and derives
  (reordered f32 sums: ``CNN_TOL`` for the f32 CNN, ``LM_TOL`` for the LM's
  bf16 activations);
- a step with ``clip_norm`` small enough to bind (the moments scale with
  the global norm: a leaf counted twice or missed shows);
- a NaN ``loss_scale``: skipped on every rank, the tree bitwise;
- the CNN crashed after step 4 of 6 (``ckpt_every=2``) and restored by the
  supervisor: losses and the final tree bitwise the uninterrupted sharded
  run's (under ``train.step.deterministic()``);
- the LM's kernel config checkpointed at ``(2, 2)`` and restored at
  ``(1, 2)`` (elastic: the arrays on disk are logical): its next step
  within tolerance of one device's from the same checkpoint;
- two microbatches, and ``tp_linear`` with a narrowed bias.

Each rank also computes the train step's loss on its block of seeded
logits (``api.sharded_lm_loss``); here its value and each block's
gradient are held against JAX's ``lm_loss`` on the global logits and its
``jax.grad``.

Here the gathered gradients and updated trees are held against the JAX
package's unsharded steps on the same numpy weights (``allow_int=True``,
as ``tests/test_torch_train.py`` does), and in one process (a mesh of one
rank) the sharded steps are bitwise the unsharded ones.
"""
import dataclasses
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from _torch_lm import jax_flat, tree_to_numpy
from test_train_faults import TINY as JTINY

import _torch_train_sharding_worker as worker
from repro.configs import get_config as jget_config
from repro.core.conv import ConvParams as JConvParams
from repro.models import api as japi
from repro.models.common import ShardCtx as JShardCtx
from repro.models.common import quantize_params as jquantize
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.launch.mesh import Mesh, make_conv_mesh
from repro_torch.models import cnn
from repro_torch.models import sharding as tsh
from repro_torch.models.common import ShardCtx
from repro_torch.train import optimizer as opt
from repro_torch.train import step as st
from repro_torch.tree import tree_leaves

# (2, 2) first: it writes the checkpoint the (1, 2) ranks restore
MESHES = [(2, 2), (2, 1), (1, 2)]
JOIN_TIMEOUT_S = 120  # every check of one mesh, all ranks
# the gathered sharded step vs JAX's unsharded one: f32 for the CNN
# (another order of the same products: the worker's CNN_TOL); for the LM
# the sum of two bounds, the port's one device vs JAX (tests/
# test_torch_train.py's LM_TOL) and the sharded step vs one device (the
# worker's LM_TOL): 2·LM_TOL
CNN_TOL, LM_TOL = worker.CNN_TOL, 2 * worker.LM_TOL
B, S = 4, 9


def _jax_lm_config(impl: str):
    """The JAX package's side of ``worker.lm_config(impl)``: the same
    weights quantized, run on ``dequant`` (the Pallas kernel's function)."""
    c = worker.lm_config(impl)
    cfg = jget_config("qwen3-32b", smoke=True).with_quant(
        enabled=True, impl="dequant", min_weight_elems=1024,
        quantize_embed=c.quant.quantize_embed)
    return dataclasses.replace(cfg, n_layers=c.n_layers)


def _jax_lm_step(cfg, ocfg):
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


def _ocfg(mod, clip: bool):
    kw = dict(lr=1e-2, total_steps=64, warmup_steps=1)
    return mod.AdamWConfig(**kw, clip_norm=worker.CLIP) if clip else mod.AdamWConfig(**kw)


@pytest.fixture(scope="module")
def cases():
    """The numpy weights and batches every rank trains from, and the JAX
    package's one step from them: its gradients and updated trees."""
    rng = np.random.default_rng(0)
    convs = [(rng.standard_normal((c.c_out, c.c_in, c.ky, c.kx)).astype(np.float32) / 3,
              rng.standard_normal(c.c_out).astype(np.float32) / 10)
             for c in worker.TINY.layers]
    C, H, W = cnn.feature_shape(worker.TINY)
    head_w = rng.standard_normal((C * H * W, worker.TINY.classes)).astype(np.float32) / 8
    head_b = rng.standard_normal(worker.TINY.classes).astype(np.float32) / 10
    tree = worker.cnn_tree({"kernels": [k for k, _ in convs], "biases": [b for _, b in convs],
                            "head_w": head_w, "head_b": head_b, "codebooks": []})
    cbs = cnn.qat_codebooks(tree["params"], worker.TINY)
    data = {"cnn": {"kernels": [k for k, _ in convs], "biases": [b for _, b in convs],
                    "head_w": head_w, "head_b": head_b,
                    "codebooks": [c.numpy() for c in cbs]}, "lm": {}}
    refs = {"cnn": {}, "lm": {}}
    # the JAX CNN step on the same tree and batch
    jtree = {"params": {"conv": [JConvParams.dense(jnp.asarray(k), bias=jnp.asarray(b))
                                 for k, b in convs],
                        "head": {"w": jnp.asarray(head_w), "b": jnp.asarray(head_b)}},
             "codebooks": [jnp.asarray(c.numpy()) for c in cbs]}
    batch = {k: jnp.asarray(v.numpy()) for k, v in worker.cnn_batch(0).items()}
    grads = jax.grad(lambda t: jstep.cnn_qat_loss(t, batch, JTINY))(jtree)
    refs["cnn"]["grads"] = jax_flat(grads)
    for name in ("step", "clip"):
        fn = jax.jit(jstep.make_cnn_train_step(JTINY, _ocfg(jopt, name == "clip")))
        new = fn(jtree, jopt.init_opt_state(jtree), batch)
        refs["cnn"][name] = jax_flat(new[:2])
    toks = rng.integers(0, 256, (B, S + 2)).astype(np.int32)
    batches = [(np.roll(toks, s, 1)[:, :S - 1], np.roll(toks, s, 1)[:, 1:S])
               for s in range(3)]
    for impl in worker.LM_IMPLS:
        jc = _jax_lm_config(impl)
        jp = jax.jit(lambda k, jc=jc: jquantize(japi.get_model(jc).init_params(jc, k), jc))(
            jax.random.PRNGKey(0))
        data["lm"][impl] = {"params": tree_to_numpy(jp), "batches": batches}
        x, y = batches[0]
        jb = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
        out = {}
        for name in ("step", "clip"):
            p, s_, m, g = _jax_lm_step(jc, _ocfg(jopt, name == "clip"))(
                jp, jopt.init_opt_state(jp), jb)
            out[name] = jax_flat((p, s_))
            out["grads"], out["loss"] = jax_flat(g), float(m["loss"])
        refs["lm"][impl] = out
    data["loss"], refs["loss"] = _loss_cases()
    return data, refs


# the sharded loss vs JAX's on the global f32 logits: both take the same
# f32 log-softmax, a rank's in parts summed over the axes, so they differ
# by the reordered f32 sums
LOSS_RTOL, LOSS_GRAD_ATOL = 1e-6, 1e-6


def _loss_cases():
    """Seeded global logits ``(4, 5, V)``, labels and masks, and JAX's
    ``lm_loss`` on them with its gradient: V = 32 (a block of 16 columns a
    rank at ``model`` 2) and V = 33 (``model`` does not divide it: the head
    is replicated); labels in every vocab block; a mask that zeroes all the
    rows of ``data`` rank 1 (rows 2 and 3), and no mask."""
    rng = np.random.default_rng(7)
    data, refs = {}, {}
    for name, V, masked in (("v32_mask", 32, True), ("v32", 32, False),
                            ("v33_mask", 33, True)):
        logits = (3 * rng.standard_normal((4, 5, V))).astype(np.float32)
        labels = rng.integers(0, V, (4, 5)).astype(np.int32)
        labels[:, 0], labels[:, 1] = 0, V - 1  # the first and the last block
        mask = None
        if masked:
            mask = (rng.random((4, 5)) < 0.7).astype(np.float32)
            mask[0, 0] = 1.0
            mask[2:] = 0.0
        data[name] = {"logits": logits, "labels": labels, "mask": mask}
        lb, m = jnp.asarray(labels), None if mask is None else jnp.asarray(mask)
        loss, grad = jax.value_and_grad(lambda z: japi.lm_loss(z, lb, m))(jnp.asarray(logits))
        refs[name] = {"loss": float(loss), "grad": np.asarray(grad)}
    return data, refs


def _spawn(shape, cases_path, d):
    world = shape[0] * shape[1]
    ctx = tmp.start_processes(
        worker.run, args=(world, shape, str(d / "store"), str(cases_path), str(d)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                pytest.fail(f"mesh {shape}: ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def runs(cases, tmp_path_factory):
    """Every check on every mesh shape, in ``MESHES``' order: ``{shape:
    [each rank's results]}``, a rank's results a dict check → (status,
    outputs)."""
    root = tmp_path_factory.mktemp("train_sharding")
    with open(root / "cases.pkl", "wb") as f:
        pickle.dump(cases[0], f)
    out = {}
    for shape in MESHES:
        d = root / f"{shape[0]}x{shape[1]}"
        d.mkdir()
        out[shape] = _spawn(shape, root / "cases.pkl", d)
    return out


def _result(runs, shape, name):
    res = runs[shape]
    for r, rr in enumerate(res):
        status, val = rr[name]
        assert status == "ok", f"mesh {shape}, rank {r}, check {name}:\n{val}"
    return [rr[name][1] for rr in res]


def _stacked(flat: dict) -> dict:
    """A port tree's ``{path: array}`` keyed as the JAX package's: the
    per-layer lists stacked on a leading axis (``_torch_lm.port_flat``)."""
    out, stacked = {}, set()
    for k, v in flat.items():
        parts = k.split("/")
        if "layers" in parts:
            i = parts.index("layers")
            parts = parts[:i + 1] + parts[i + 2:]
            stacked.add("/".join(parts))
        out.setdefault("/".join(parts), []).append(v)
    return {k: np.stack(v) if k in stacked else v[0] for k, v in out.items()}


def _hold(got: dict, want: dict, tol: float, what: str, *, g_floor: float,
          params: bool = True) -> None:
    """The worker's ``update_close`` against the JAX package's flattened
    tree: ``mu`` within ``tol`` of each leaf's max and ``nu`` within
    ``2·tol``; with ``params`` the new params within 1e-5 where the first
    moment is at least ``g_floor`` of its leaf's max."""
    for k, w in want.items():
        if k.endswith("/idx") or k.endswith("step"):
            continue
        g = got[k]
        assert g.shape == w.shape, (what, k)
        w = np.asarray(w, np.float32)
        if k.startswith("0/"):
            if params:
                mu = np.abs(np.asarray(want["1/mu/" + k[2:]]))
                m = mu >= g_floor * mu.max(initial=0)
                np.testing.assert_allclose(g[m], w[m], rtol=1e-5, atol=1e-5,
                                           err_msg=(what, k))
        else:
            t = 2 * tol if k.startswith("1/nu/") else tol
            np.testing.assert_allclose(g, w, rtol=0, atol=t * float(np.abs(w).max(initial=0)),
                                       err_msg=(what, k))


MESH_IDS = [f"{a}x{b}" for a, b in MESHES]


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_cnn_step_matches_one_device_and_jax(runs, cases, shape):
    """Every rank held its loss, gradients, update and binding-clip update
    to one device's and skipped the NaN step; here the ranks agree and the
    gathered gradients and trees are the JAX package's step within f32
    noise."""
    outs = _result(runs, shape, "cnn")
    ref = cases[1]["cnn"]
    for o in outs[1:]:  # every rank gathers the same global tree
        for k in ("grads", "step", "clip"):
            for key, v in outs[0][k].items():
                np.testing.assert_array_equal(o[k][key], v)
    got = outs[0]
    for k, w in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, rtol=0,
                                   atol=CNN_TOL * float(np.abs(w).max()), err_msg=k)
    for name in ("step", "clip"):
        _hold(got[name], ref[name], CNN_TOL, name, g_floor=worker.G_FLOOR,
              params=name == "step")
    if shape != (1, 1):
        assert outs[0]["bytes"]["grad_reduce"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_cnn_crash_resume_bitwise(runs, shape):
    """The supervised sharded run with a crash after step 4: bitwise the
    uninterrupted sharded run (held in the ranks), its losses finite."""
    outs = _result(runs, shape, "cnn_resume")
    assert all(np.isfinite(outs[0]["losses"]))
    assert all(o["losses"] == outs[0]["losses"] for o in outs)


@pytest.mark.parametrize("impl", worker.LM_IMPLS)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_lm_step_matches_one_device_and_jax(runs, cases, shape, impl):
    """The qwen3 smoke step (``dequant``; ``kernel`` with ``remat`` and a
    quantized, vocab-sharded embedding) under an active context: held to
    one device in the ranks (loss, gradients, update, binding clip, NaN
    skip, two microbatches); here the gathered gradients and trees against
    the JAX package's unsharded step within the LM tolerance."""
    outs = _result(runs, shape, f"lm_{impl}")
    ref = cases[1]["lm"][impl]
    got = outs[0]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3)
    grads = _stacked(got["grads"])
    assert set(grads) == {k for k in ref["grads"] if not k.endswith("/idx")}
    for k, g in grads.items():
        w = ref["grads"][k]
        np.testing.assert_allclose(g, w, rtol=0, atol=LM_TOL * float(np.abs(w).max()),
                                   err_msg=k)
    for name in ("step", "clip"):
        _hold(_stacked(got[name]), ref[name], LM_TOL, name, g_floor=2 * LM_TOL,
              params=name == "step")
    # the worst gradient leaf, |Δ| / max, of the ranks' own comparison
    assert all(o["grad_err"] <= worker.LM_TOL for o in outs)
    nd, nm = shape
    by = got["bytes"]
    assert (by["all_reduce_bwd"] > 0) == (nm > 1)  # replicated x into N/K blocks
    assert by["grad_reduce"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_sharded_loss_matches_jax(runs, cases, shape):
    """``api.sharded_lm_loss`` on each rank's block of the logits: the
    global loss of JAX's ``lm_loss`` on the global logits within 1e-6
    relative on every rank, and each rank's gradient its block of
    ``jax.grad`` within 1e-6; the blocks cover every row and column; the
    loss's collectives moved bytes exactly where a dim of the logits split
    (``model`` where it divides the vocab, ``data`` on the rows)."""
    outs = _result(runs, shape, "loss")
    nd, nm = shape
    for name, ref in cases[1]["loss"].items():
        V = ref["grad"].shape[-1]
        seen = np.zeros(ref["grad"].shape, bool)
        for r, o in enumerate(outs):
            got = o[name]
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL,
                                       err_msg=(name, r))
            cols = slice(*got["cols"])
            want = ref["grad"][got["rows"]][..., cols]
            assert got["grad"].shape == want.shape, (name, r)
            np.testing.assert_allclose(got["grad"], want, rtol=0, atol=LOSS_GRAD_ATOL,
                                       err_msg=(name, r))
            seen[got["rows"], :, cols] = True
            split = nd > 1 or (nm > 1 and V % nm == 0)
            assert (got["bytes"] > 0) == split, (name, r, got["bytes"])
        assert seen.all(), name


@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_bias_and_codebook_of_a_block(runs, shape):
    _result(runs, shape, "bias_linear")


def test_elastic_restore_2x2_to_1x2(runs):
    """Saved by 4 ranks at (2, 2), restored by 2 at (1, 2): each rank held
    its blocks bitwise the logical arrays' and the next step to one
    device's from the same checkpoint."""
    saved = _result(runs, (2, 2), "elastic")
    _result(runs, (1, 2), "elastic")
    for o in saved[1:]:
        for k, v in saved[0]["saved"].items():
            np.testing.assert_array_equal(o["saved"][k], v)


# ---------------------------------------------------------------------------
# in one process: (1, 1) bitwise, the reduction table, refusals
# ---------------------------------------------------------------------------


def _cpu_mesh(shape, coords) -> Mesh:
    return Mesh(tuple(shape), ("data", "model"), tuple(coords), (None, None),
                torch.device("cpu"))


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("what", ["cnn", "dequant", "kernel"])
def test_mesh_1x1_step_is_bitwise_the_unsharded(cases, what):
    mesh = make_conv_mesh((1, 1), device="cpu")
    with st.deterministic():
        if what == "cnn":
            tree = worker.cnn_tree(cases[0]["cnn"])
            batch = worker.cnn_batch(0)
            a = st.make_cnn_train_step(worker.TINY, worker.OCFG)(
                tree, opt.init_opt_state(tree), batch)
            placed = cnn._place(tree, mesh)
            b = st.make_cnn_train_step(worker.TINY, worker.OCFG, mesh=mesh)(
                placed, opt.init_opt_state(placed), batch)
        else:
            cfg = worker.lm_config(what)
            params = interop.lm_params_from_numpy(cases[0]["lm"][what]["params"],
                                                  device="cpu")
            batch = worker.lm_batch(cases[0]["lm"][what])
            a = st.make_train_step(cfg, worker.OCFG)(params, opt.init_opt_state(params),
                                                      batch)
            placed = tsh.place_params(params, mesh)
            b = st.make_train_step(cfg, worker.OCFG, ShardCtx.for_mesh(mesh, B))(
                placed, opt.init_opt_state(placed), batch)
    assert _same(a[:2], b[:2])
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert torch.equal(a[2]["grad_norm"], b[2]["grad_norm"])


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_grad_reduce_axes_by_leaf_kind(cases, shape):
    """Which axes each kind of leaf's gradient sums over: ``data`` always
    (the rows split there); a split leaf's idx / dense block never over
    ``model``; its whole codebook over ``model``; a replicated norm scale
    not over ``model``, the per-head ``q_norm``/``k_norm`` over it; the
    vocab-sharded embedding's block not, its codebook over it; the CNN's
    ``c_out`` blocks not, each layer's dictionary over it."""
    nd, nm = shape
    d = ("data",) if nd > 1 else ()
    dm = d + (("model",) if nm > 1 else ())
    mesh = _cpu_mesh(shape, (0, 0))
    params = interop.lm_params_from_numpy(cases[0]["lm"]["kernel"]["params"], device="cpu")
    placed = tsh.place_params(params, mesh)
    ax = {"/".join(k): v for k, v in tsh.grad_reduce_axes(placed, mesh).items()}
    blocks = {"/".join(k): v for k, v in tsh.block_axes(placed, mesh).items()}
    m = ("model",) if nm > 1 else ()
    for k in ("layers/0/attn/wq/idx", "layers/0/mlp/w2/idx", "embed/idx", "lm_head/idx"):
        assert ax[k] == d and blocks[k] == m, k
    for k in ("layers/0/attn/wq/codebook", "layers/1/mlp/w2/codebook", "embed/codebook",
              "lm_head/codebook", "layers/0/attn/q_norm", "layers/1/attn/k_norm"):
        assert ax[k] == dm and blocks[k] == (), k
    for k in ("layers/0/attn_norm", "final_norm"):
        assert ax[k] == d and blocks[k] == (), k
    dense = interop.lm_params_from_numpy(cases[0]["lm"]["dequant"]["params"], device="cpu")
    pd = tsh.place_params(dense, mesh)
    axd = {"/".join(k): v for k, v in tsh.grad_reduce_axes(pd, mesh).items()}
    assert axd["embed/w" if nm > 1 else "embed"] == d  # a dense vocab block
    tree = cnn._place(worker.cnn_tree(cases[0]["cnn"]), mesh)
    specs = cnn.qat_specs(worker.TINY, mesh)
    axc = {"/".join(k): v for k, v in tsh.grad_reduce_axes(
        tree, mesh, specs, reads=cnn.qat_reads(worker.TINY)).items()}
    assert axc["params/conv/0/kernel"] == d and axc["params/conv/0/bias"] == d
    assert axc["params/head/w"] == d and axc["codebooks/0"] == dm


def test_gather_params_inverts_the_placements(cases):
    """``gather_params`` of a rank's blocks on a mesh of one rank a
    coordinate is those blocks; concatenated over the coordinates (here by
    hand, no process group) they are the global leaves."""
    params = interop.lm_params_from_numpy(cases[0]["lm"]["kernel"]["params"], device="cpu")
    mesh = make_conv_mesh((1, 1), device="cpu")
    assert _same(tsh.gather_params(tsh.place_params(params, mesh), mesh), params)
    like = tsh.global_like(tsh.place_params(params, _cpu_mesh((1, 2), (0, 1))),
                           _cpu_mesh((1, 2), (0, 1)))
    assert [tuple(x.shape) for x in tree_leaves(like)] == \
        [tuple(x.shape) for x in tree_leaves(params)]
    tree = worker.cnn_tree(cases[0]["cnn"])
    m = _cpu_mesh((1, 2), (0, 1))
    like = tsh.global_like(cnn._place(tree, m), m, cnn.qat_specs(worker.TINY, m))
    assert [tuple(x.shape) for x in tree_leaves(like)] == \
        [tuple(x.shape) for x in tree_leaves(tree)]


def test_sharded_training_refusals_name_item_13b(cases):
    """Formerly refused under a mesh (ROADMAP item 13b, now ported): MoE and
    vlm training under an active context and compressed gradients run, at
    mesh (1, 1) bitwise the unsharded calls (the multi-rank checks are
    ``tests/test_torch_family_train_sharding.py``'s), and no refusal names
    the item; dictionaries drawn from placed masters still raise (they need
    the global masters)."""
    from repro_torch.core import params as tpar
    from repro_torch.models import api as tapi
    from repro_torch.models.common import quantize_params

    assert not [n for n in dir(tpar) if n.startswith("NOT_PORTED")]
    mesh = make_conv_mesh((1, 1), device="cpu")
    sctx = ShardCtx.for_mesh(mesh, 2)
    toks = torch.arange(8).reshape(2, 4) % 7
    rng = np.random.default_rng(2)
    for arch in ("deepseek-moe-16b", "internvl2-26b"):
        cfg = worker.get_config(arch, smoke=True).with_quant(enabled=True,
                                                             min_weight_elems=1024)
        params = quantize_params(tapi.get_model(cfg).init_params(
            cfg, torch.Generator().manual_seed(0)), cfg, iters=2)
        batch = {"tokens": toks[:, :3], "labels": toks[:, 1:]}
        if cfg.frontend == "vit":
            batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32))
        with st.deterministic():
            a = st.loss_and_grads(params, batch, cfg)
            b = st.loss_and_grads(tsh.place_params(params, mesh), batch, cfg, sctx)
        assert torch.equal(a[0], b[0]) and _same(a[2], b[2]), arch
    cfg = worker.lm_config("dequant")
    params = interop.lm_params_from_numpy(cases[0]["lm"]["dequant"]["params"], device="cpu")
    batch = worker.lm_batch(cases[0]["lm"]["dequant"])
    w = {"w": torch.from_numpy(rng.standard_normal((6, 4)).astype(np.float32)),
         "b": torch.from_numpy(rng.standard_normal(4).astype(np.float32))}
    assert _same(opt.compress_grads(w, 16, mesh=mesh), opt.compress_grads(w, 16))
    with st.deterministic():
        a = st.make_train_step(cfg, worker.OCFG, compress_grads_bins=16)(
            params, opt.init_opt_state(params), batch)
        placed = tsh.place_params(params, mesh)
        b = st.make_train_step(cfg, worker.OCFG, ShardCtx.for_mesh(mesh, B),
                               compress_grads_bins=16)(
            placed, opt.init_opt_state(placed), batch)
    assert _same(a[:2], b[:2])
    tree = worker.cnn_tree({"kernels": [np.zeros((4, 1, 3, 3), np.float32)],
                            "biases": [np.zeros(4, np.float32)],
                            "head_w": np.zeros((36, 4), np.float32),
                            "head_b": np.zeros(4, np.float32), "codebooks": []})
    m2 = _cpu_mesh((1, 2), (0, 0))
    with pytest.raises(ValueError, match="global masters"):
        cnn.qat_codebooks(cnn._place(tree, m2)["params"], worker.TINY)
