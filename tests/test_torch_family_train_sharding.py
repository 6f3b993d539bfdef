"""Sharded training of every LM family, against one device and the JAX package, on the CPU.

The train steps of deepseek-moe-16b, internvl2-26b (the vit prefix),
mamba2-130m, recurrentgemma-2b, whisper-tiny, phi3-medium-14b (5 KV heads:
``model`` 2 cuts them, so q, k and v are gathered whole) and qwen3-32b with
one KV head (its per-head ``q_norm``/``k_norm`` then act on whole heads on
every rank) run under an active ``ShardCtx`` on params placed by
``models/sharding.py::place_params``, SPMD, one gloo process a rank, one
``torch.multiprocessing`` spawn a mesh shape: ``(2, 2)`` (it writes the
checkpoint ``(1, 2)`` restores), ``(2, 1)``, ``(1, 2)``
(``tests/_torch_family_train_sharding_worker.py``), each on ``dequant``
and ``kernel``, all in f32 activations.  Each rank holds against the
port's one-device step, in its own process, the loss and every gradient
leaf within the worker's ``GRAD_TOL`` (2^-12 of the leaf's max: f32 sums in
another order), the MoE with the mesh's dispatch groups and its routing
flips checked to be near-ties; a ZeRO-1 step bitwise the step with whole
moments, its moment blocks bitwise ``local_shard`` of the whole ones;
``compress_grads(mesh=)`` bitwise the block of the gathered compression;
the ZeRO checkpoint (2, 2) → (1, 2).

Here the gathered gradients are held against the JAX package's unsharded
step on the same numpy weights (``allow_int=True``, under ``jax.jit``, f32
activations): within ``JAX_TOL``, the port's one device vs JAX (K1's plain
version and the dequantized product sum in another order than XLA's dot,
2^-12) plus the worker's bound (the gathered gradients measured at most
5.9e-6 of a leaf's max from JAX's).  JAX's MoE
routing is read through a debug callback and held to the port's the same
way.

In one process: each step at mesh ``(1, 1)`` bitwise the unsharded one;
the three faults of the gradient machinery this slice fixed, each at the
level it lived (the reduction table's ``data`` sum of a leaf split over
``data``, the backward of a gather feeding rank-distinct work, the
per-head norms' ``model`` sum where the heads are not split); the ZeRO-1
specs against ``repro.models.sharding.opt_state_pspecs``.
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
from _torch_lm import f32_activations, jax_flat

import _torch_family_train_sharding_worker as worker
import _torch_heads
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.models import sharding as jsh
from repro.models.common import ShardCtx as JShardCtx
from repro.models.common import quantize_params as jquantize
from repro.nn import moe as JM
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.launch.mesh import Mesh, make_conv_mesh
from repro_torch.models import api as tapi
from repro_torch.models import sharding as tsh
from repro_torch.models.common import ShardCtx, quantize_params
from repro_torch.train import optimizer as opt
from repro_torch.train import step as st
from repro_torch.tree import flatten_with_path, tree_leaves

MESHES = [(2, 2), (2, 1), (1, 2)]
MESH_IDS = [f"{a}x{b}" for a, b in MESHES]
JOIN_TIMEOUT_S = 240  # every check of one mesh, all ranks
JAX_TOL = 2.0 ** -12 + worker.GRAD_TOL
B, S = worker.B, worker.S
KEYS = list(worker.MODELS)
FOUR_MESH = (1, 4)  # trains worker.FOUR: q heads split by gcd(n_heads, 4)
SPECS = {**worker.MODELS, **worker.FOUR}
_LISTS = ("layers", "groups", "enc_layers", "dec_layers")  # JAX stacks these


def _jcfg(key: str):
    arch, changes = SPECS[key]
    return dataclasses.replace(jget_config(arch, smoke=True), **changes).with_quant(
        enabled=True, impl="dequant", min_weight_elems=1024)


def _modules(key: str):
    """The JAX and the port model modules of ``key`` (for f32 activations)."""
    c = _jcfg(key)
    return japi.get_model(c), tapi.get_model(worker.config(key, "dequant"))


def _jax_grads(jc, dp: int):
    """The JAX package's ``make_train_step`` loss and gradients (its
    ``_loss_fn`` differentiated with ``allow_int=True``), jitted."""
    model = japi.get_model(jc)

    def fn(params, batch):
        (loss, _), grads = jax.value_and_grad(jstep._loss_fn, has_aux=True, allow_int=True)(
            params, batch, jc, JShardCtx(dp=dp), model, None)
        return loss, grads

    return jax.jit(fn)


def _np_tree(t):
    """A port params tree in :func:`tree_to_numpy`'s layout (the JAX
    package's: each per-layer list stacked on a leading axis, containers as
    field dicts), the format ``interop.lm_params_from_numpy`` reads."""
    from repro_torch.core.conv import ConvParams
    from repro_torch.core.params import PasmParams

    def arr(a):
        return None if a is None else a.detach().numpy()

    if isinstance(t, PasmParams):
        return {"kind": t.kind, "shape": t.shape, "bins": t.bins, "pad_k": t.pad_k,
                **{f: arr(getattr(t, f)) for f in ("w", "idx", "codebook", "bias")}}
    if isinstance(t, ConvParams):
        return {"kind": t.kind, "kshape": t.kshape, "bins": t.bins, "order": t.order,
                "pad_k": t.pad_k,
                **{f: arr(getattr(t, f)) for f in ("kernel", "idx", "codebook", "bias")}}
    if isinstance(t, dict):
        return {k: _stack([_np_tree(x) for x in v]) if k in _LISTS else _np_tree(v)
                for k, v in t.items()}
    if isinstance(t, list):
        return [_np_tree(v) for v in t]
    return arr(t)


def _stack(items: list):
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) if k not in (
            "kind", "shape", "bins", "pad_k", "kshape", "order") else first[k]
            for k in first}
    return None if first is None else np.stack(items)


def _jax_tree(t):
    """A :func:`tree_to_numpy`-layout tree as the JAX package's containers."""
    from repro.core.conv import ConvParams as JConv
    from repro.core.params import PasmParams as JPasm

    if isinstance(t, dict) and "kshape" in t:
        return JConv(**{f: None if t[f] is None else jnp.asarray(t[f])
                        for f in ("kernel", "idx", "codebook", "bias")},
                     kind=t["kind"], kshape=tuple(t["kshape"]), bins=t["bins"],
                     order=t["order"], pad_k=t["pad_k"])
    if isinstance(t, dict) and "kind" in t:
        return JPasm(**{f: None if t[f] is None else jnp.asarray(t[f])
                        for f in ("w", "idx", "codebook", "bias")},
                     kind=t["kind"], shape=tuple(t["shape"]), bins=t["bins"], pad_k=t["pad_k"])
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


class _routes:
    """JAX's MoE router inputs, in call order, through a debug callback."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        self.inner = JM.moe_ffn
        log = self.log

        def spy(x, params, cfg, **kw):
            jax.debug.callback(lambda a: log.append(np.array(a)), x.astype(jnp.float32),
                               ordered=True)
            return self.inner(x, params, cfg, **kw)

        JM.moe_ffn = spy
        return self

    def __exit__(self, *exc):
        JM.moe_ffn = self.inner


@pytest.fixture(scope="module")
def cases():
    """The JAX weights and batches every rank trains from (numpy), and the
    JAX package's unsharded loss and gradients from them (the MoE with one
    and with two dispatch groups, the DP degrees of the meshes), with its
    MoE router inputs."""
    rng = np.random.default_rng(5)
    data, refs = {}, {}
    for key in SPECS:
        jc = _jcfg(key)
        jm, tm = _modules(key)
        tc = worker.config(key, "dequant")
        tp = quantize_params(tm.init_params(tc, torch.Generator().manual_seed(0)), tc,
                             iters=2)
        npp = _np_tree(tp)
        jp = _jax_tree(npp)
        toks = rng.integers(0, jc.vocab, (B, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if jc.frontend == "vit":
            batch["frontend_embeds"] = rng.standard_normal(
                (B, jc.frontend_tokens, jc.frontend_dim)).astype(np.float32)
        if jc.family == "audio":
            batch["frontend_embeds"] = rng.standard_normal(
                (B, jc.n_mels, 2 * jc.frontend_tokens)).astype(np.float32)
        data[key] = {"params": npp, "batch": batch}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        refs[key] = {}
        with f32_activations(jm, tm):
            for dp in ((1, 2) if jc.moe else (1,)):
                loss, grads = _jax_grads(jc, dp)(jp, jb)
                refs[key][dp] = {"loss": float(loss), "grads": jax_flat(grads)}
                if jc.moe:  # the router inputs of the same forward
                    with _routes() as routes:
                        jax.jit(lambda p, t, dp=dp, jc=jc, jm=jm: jm.forward(
                            p, t, jc, JShardCtx(dp=dp))[0])(jp, jb["tokens"])
                        jax.effects_barrier()
                    refs[key][dp]["routes"] = routes.log
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
    root = tmp_path_factory.mktemp("family_train_sharding")
    with open(root / "cases.pkl", "wb") as f:
        pickle.dump(cases[0], f)
    out = {}
    for shape in MESHES + [FOUR_MESH]:
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
    per-layer (per-group) lists stacked on a leading axis."""
    out, stacked = {}, set()
    for k, v in flat.items():
        parts = k.split("/")
        lists = [i for i, p in enumerate(parts)
                 if p in ("layers", "groups", "enc_layers", "dec_layers")]
        if lists:
            i = lists[0]
            parts = parts[:i + 1] + parts[i + 2:]
            stacked.add("/".join(parts))
        out.setdefault("/".join(parts), []).append(v)
    return {k: np.stack(v) if k in stacked else v[0] for k, v in out.items()}


def _jax_port_flips(key: str, jlog: list, rows_of) -> int:
    """Tokens whose experts the port's one-device run chose otherwise than
    JAX (the port's router on JAX's router inputs), each a near-tie."""
    from repro_torch.nn import moe as TM

    jc = _jcfg(key)
    k = jc.moe.top_k
    n = 0
    for i, xj in enumerate(jlog):
        router = rows_of(i)
        pj = np.asarray(jax.nn.softmax(jnp.dot(jnp.asarray(xj), jnp.asarray(router)), -1))
        ij = np.sort(np.asarray(jax.lax.top_k(jnp.asarray(pj), k)[1]), -1)
        it = np.sort(TM.route(torch.from_numpy(xj), torch.from_numpy(router), k)[2].numpy(),
                     -1)
        for t in np.flatnonzero((ij != it).any(-1)):
            kth = np.sort(pj[t])[-k]
            assert all(pj[t, e] >= kth * (1 - worker.TIE) for e in set(it[t]) - set(ij[t]))
            n += 1
    return n


def _hold_step(runs, cases, shape, key: str, impl: str) -> None:
    """Every rank gathered the same gradients, JAX's unsharded step's
    within ``JAX_TOL``; the ranks held them to one device's."""
    outs = _result(runs, shape, f"step/{key}/{impl}")
    for o in outs[1:]:
        for k, v in outs[0]["grads"].items():
            np.testing.assert_array_equal(o["grads"][k], v)
    dp = shape[0] if SPECS[key][0] == "deepseek-moe-16b" else 1
    ref = cases[1][key][dp]
    got = outs[0]
    if key == "moe":  # JAX's experts are the port's one device's
        routers = np.asarray(cases[0][key]["params"]["layers"]["moe"]["router"])
        assert _jax_port_flips(key, ref["routes"], lambda i: routers[i]) == 0
    assert all(o["flips"] == 0 for o in outs), "a routing flip: the grads were not compared"
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    grads = _stacked(got["grads"])
    assert set(grads) == {k for k in ref["grads"] if not k.endswith("/idx")}
    for k, g in grads.items():
        w = ref["grads"][k]
        np.testing.assert_allclose(g, w, rtol=0, atol=JAX_TOL * float(np.abs(w).max()),
                                   err_msg=k)
    assert all(max(o["worst"].values()) <= worker.GRAD_TOL for o in outs)
    by = got["bytes"]
    assert by["grad_reduce"] > 0
    if shape[1] > 1:
        assert by["all_reduce_bwd"] > 0  # replicated activations entered rank blocks


def _assert_heads(runs, shape, key: str, impl: str) -> None:
    """Each rank's head block and the heads its attention ran on in the
    step (``tests/_torch_heads.py::HEADS``)."""
    cfg = worker.config(key, impl)
    for r, o in enumerate(_result(runs, shape, f"step/{key}/{impl}")):
        (q0, nq), seen = o["heads"]
        w0, wn, wkv = _torch_heads.want(cfg.n_heads, cfg.n_kv_heads, shape[1], r % shape[1])
        assert (q0, nq) == (w0, wn), (shape, r, key, (q0, nq))
        assert seen == [(wn, wkv)], (shape, r, key, seen)


@pytest.mark.parametrize("impl", worker.IMPLS)
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_family_step_matches_one_device_and_jax(runs, cases, shape, key, impl):
    """The ranks held the loss and every gradient leaf to one device's
    (``GRAD_TOL``); here every rank gathered the same gradients, which are
    JAX's unsharded step's within ``JAX_TOL``, and a ``model`` split moved
    activations and gradients through the collectives.  The hybrid's one
    KV head and the 6-head variant's 3 do not divide ``model`` 2: each
    rank ran attention on its block of the q heads."""
    _hold_step(runs, cases, shape, key, impl)
    if key in ("hybrid", "straddle"):
        _assert_heads(runs, shape, key, impl)


@pytest.mark.parametrize("impl", worker.IMPLS)
@pytest.mark.parametrize("key", list(worker.FOUR))
def test_family_step_with_q_heads_split_by_gcd_at_model_4(runs, cases, key, impl):
    """At (1, 4), where 2 or 3 KV heads do not divide ``model``: qwen3's
    smoke trains one q head a rank, the 6-head variant a block of 3 on two
    ranks each (disjoint K rows of ``wo``; ``q_norm``/``k_norm`` summed over
    ``model`` once).  Loss and every gradient leaf as at the other meshes,
    and each rank's attention ran on its block."""
    _hold_step(runs, cases, FOUR_MESH, key, impl)
    _assert_heads(runs, FOUR_MESH, key, impl)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", [(2, 2), (2, 1)], ids=["2x2", "2x1"])
def test_zero_step_is_bitwise_the_whole_moment_step(runs, shape, key):
    """JAX's ZeRO-1 moments: the step bitwise the step with whole moments,
    each rank's moment blocks ``local_shard`` of the whole ones (held in
    the ranks); a rank holds fewer moment bytes, and the step gathered its
    params over ``data``."""
    for o in _result(runs, shape, f"zero/{key}"):
        assert o["moment_bytes"] < o["whole_bytes"]
        assert o["bytes"]["zero_gather"] > 0


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", MESHES, ids=MESH_IDS)
def test_compress_grads_on_a_mesh_is_the_block_of_the_global(runs, shape, key):
    """``compress_grads(mesh=)``: each leaf's dictionary from the whole
    leaf's ``max |g|`` (a MAX all-reduce over its split axes), so a rank's
    result is bitwise its block of the compressed gathered gradient (held
    in the ranks), and the compressed step runs."""
    outs = _result(runs, shape, f"compress/{key}")
    if shape[1] > 1:  # float leaves split over model: their max crossed ranks
        assert outs[0]["bytes"]["grad_max"] > 0


def test_zero_checkpoint_restores_elastically_2x2_to_1x2(runs):
    """The MoE's ZeRO state saved by 4 ranks at (2, 2) (expert stacks cut
    on E and ``Fe``, moments over ``data``), restored by 2 at (1, 2): each
    rank held every block bitwise this mesh's block of the logical arrays
    and took the next step; here the four ranks saved the same tree."""
    saved = _result(runs, (2, 2), "elastic")
    _result(runs, (1, 2), "elastic")
    for o in saved[1:]:
        for k, v in saved[0]["saved"].items():
            np.testing.assert_array_equal(o["saved"][k], v)


@pytest.mark.parametrize("key", ["ssm", "hybrid"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
def test_fault_gather_into_rank_distinct_work(runs, shape, key):
    """Fault (b): a column block gathered whole (``models/common.py::
    whole_cols``) takes back only its own block of the gradient, right
    only where what reads the gathered tensor runs the same on every rank.
    mamba2's conv channels, its scan on a P block and its gated norm's
    block, and the RG-LRU's channel block, read it rank-distinctly: the
    replicated tensor now passes ``enter_split`` there.  Each rank held
    the gradients, reduced by the table, to one device's (the parent tree
    gave partial gradients)."""
    outs = _result(runs, shape, f"fault_1b/{key}")
    assert all(max(o["worst"].values()) <= worker.GRAD_TOL for o in outs)


# ---------------------------------------------------------------------------
# in one process: (1, 1) bitwise, the reduction table, JAX's ZeRO specs
# ---------------------------------------------------------------------------


def _cpu_mesh(shape, coords=(0, 0)) -> Mesh:
    """One rank's view of a mesh with no process groups: placement needs none."""
    return Mesh(tuple(shape), ("data", "model"), tuple(coords), (None, None),
                torch.device("cpu"))


def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _params(cases, key):
    return interop.lm_params_from_numpy(cases[0][key]["params"], device="cpu")


@pytest.mark.parametrize("key", KEYS)
def test_mesh_1x1_step_is_bitwise_the_unsharded(cases, key):
    """At mesh (1, 1) (no collective runs) the ``kernel`` step, with ZeRO
    moments and compressed gradients, is bitwise the unsharded step."""
    cfg = worker.config(key, "kernel")
    params = _params(cases, key)
    batch = worker.batch_of(cases[0][key])
    mesh = make_conv_mesh((1, 1), device="cpu")
    with st.deterministic():
        a = st.make_train_step(cfg, worker.OCFG, compress_grads_bins=16)(
            params, opt.init_opt_state(params), batch)
        placed = tsh.place_params(params, mesh)
        b = st.make_train_step(cfg, worker.OCFG, ShardCtx.for_mesh(mesh, B),
                               compress_grads_bins=16)(
            placed, opt.init_opt_state(placed, mesh=mesh), batch)
    assert _same(a[:2], b[:2])
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    assert torch.equal(a[2]["grad_norm"], b[2]["grad_norm"])


def _axes(tree, mesh) -> dict:
    return {"/".join(k): v for k, v in tsh.grad_reduce_axes(tree, mesh).items()}


def test_fault_leaf_split_over_data_is_not_summed_over_data(cases):
    """Fault (a): ``grad_reduce_axes`` summed every leaf over ``data`` when
    the batch splits, an expert stack's ``Fe`` block too.  A rank runs its
    ``Fe`` block on every group's tokens (``nn/moe.py``'s gathered
    buffers), so that block's gradient is whole already: summed over
    ``data`` it would count twice.  A leaf's own split axes now leave the
    batch's ``data`` sum; its dictionary is still summed over both blocks."""
    cfg = dataclasses.replace(worker.config("moe", "dequant"))
    dense = tapi.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
    quant = _params(cases, "moe")
    for shape in ((2, 1), (2, 2)):
        mesh = _cpu_mesh(shape)
        ax = _axes(tsh.place_params(dense, mesh), mesh)
        for n in ("w1", "w3", "w2"):
            assert ax[f"layers/0/moe/{n}/w"] == (), (shape, n)  # E and Fe blocks
        assert ax["layers/0/moe/router"] == ("data",)  # whole, on a rank's tokens
        assert ax["layers/0/attn_norm"] == ("data",)
        axq = _axes(tsh.place_params(quant, mesh), mesh)
        want = ("data",) + (("model",) if shape[1] > 1 else ())
        assert axq["layers/0/moe/w1/codebook"] == want
        assert axq["layers/0/moe/w1/idx"] == ()


def test_fault_per_head_norms_follow_the_heads(cases):
    """Fault (c): the per-head ``q_norm``/``k_norm`` gradient is a rank's
    heads' part wherever a rank runs its own block of the q heads, so it is
    summed over ``model`` exactly then.  The blocks are GSPMD's, ``gcd(q
    heads, model)`` of them (``models/common.py::head_groups``), whether or
    not the KV heads divide ``model``: 4 q heads over 1 or 2 KV heads at
    ``model`` 2 (2 blocks: the sum), 6 over 3 at ``model`` 4 (2 blocks of
    3, each on two ranks, which take disjoint K rows of ``wo``: the sum,
    once), 5 over 1 at ``model`` 2 or 4 (one block: every rank runs every
    head and holds the whole gradient, so no ``model`` sum)."""
    base = worker.config("qknorm", "dequant")
    cut = _params(cases, "qknorm")
    table = (((1, 4), (1, 2), True), ((1, 4), (2, 2), True), ((2, 4), (1, 2), True),
             ((3, 6), (1, 4), True), ((3, 6), (2, 4), True), ((1, 5), (1, 2), False),
             ((1, 5), (1, 4), False))
    for (kv, heads), shape, split in table:
        mesh = _cpu_mesh(shape)
        d = ("data",) if shape[0] > 1 else ()
        if (kv, heads) == (1, 4):
            tree = cut  # the quantized smoke tree the ranks train
        else:
            cfg = dataclasses.replace(base, n_heads=heads, n_kv_heads=kv)
            tree = tapi.get_model(cfg).init_params(cfg, torch.Generator().manual_seed(0))
        ax = _axes(tsh.place_params(tree, mesh), mesh)
        for n in ("q_norm", "k_norm"):
            assert ax[f"layers/0/attn/{n}"] == d + (("model",) if split else ()), \
                (heads, kv, shape, n)
        if (kv, heads) == (1, 4):
            assert ax["layers/0/attn/wq/codebook"] == d + ("model",)


def _jax_specs(key: str, sizes: dict) -> dict:
    """JAX's ``opt_state_pspecs`` of the same params, by JAX's leaf path."""
    from _torch_lm import _key

    jc = _jcfg(key)
    jp = jax.eval_shape(lambda k: jquantize(japi.get_model(jc).init_params(jc, k), jc,
                                            iters=2), jax.random.PRNGKey(0))
    jz = jsh.opt_state_pspecs(jp, jsh.param_pspecs(jp, sizes), sizes)
    flat = jax.tree_util.tree_flatten_with_path(
        jz, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {"/".join(_key(p) for p in path): tuple(s) for path, s in flat}


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_zero_specs_are_jax_opt_state_pspecs(cases, shape, key):
    """The ZeRO-1 layout ``init_opt_state(mesh=)`` places the moments by
    (``models/sharding.py::zero_specs``) is JAX's ``opt_state_pspecs`` of
    the same params, leaf by leaf: the port's per-layer leaves against
    JAX's stacked ones, whose leading layer axis takes ``None``.  Where JAX
    cuts that layer axis instead (a per-layer vector ``model`` holds, a
    small per-layer dictionary), which a per-layer leaf does not have, the
    port cuts a dim of the leaf over ``data``: a rank holds ``1/data`` of
    every moment JAX cuts.  Float leaves only (an index's moment is a 0-d
    placeholder in the port); each moment held is its spec's block."""
    params = _params(cases, key)
    mesh = _cpu_mesh(shape, (1, shape[1] - 1))
    placed = tsh.place_params(params, mesh)
    z = tsh.zero_specs(placed, mesh)
    want = _jax_specs(key, {"data": shape[0], "model": shape[1]})
    moments = dict(flatten_with_path(opt.init_opt_state(placed, mesh=mesh).mu))
    whole = dict(flatten_with_path(tsh.global_like(placed, mesh)))
    same = layer_cut = 0
    for path, _, spec, _ in tsh._walked(placed, z, mesh):
        if path[-1] == "idx":
            continue
        parts = list(path)
        lists = [i for i, p in enumerate(parts) if p in _LISTS]
        if lists:
            del parts[lists[0] + 1]
        jk, gpath = "/".join(parts), path
        if jk not in want and path[-1] == "w":  # a wrapped dense block: a plain leaf
            jk, gpath = jk[:-2], path[:-1]
        j = want[jk]
        g = whole[gpath]
        if lists and j[0] is not None:  # JAX cut the stacked layer axis
            assert j[0] == "data" and any(a is not None and "data" in (
                a if isinstance(a, tuple) else (a,)) for a in spec), (jk, j, spec)
            layer_cut += 1
        else:
            j = j[1:] if lists else j
            assert tuple(spec) == tuple(j) + (None,) * (len(spec) - len(j)), (jk, j, spec)
            same += 1
        blk = tsh.local_shard(torch.empty(g.shape, device="meta"), spec, mesh)
        assert tuple(moments[path].shape) == tuple(blk.shape), (jk, spec)
        if any(a is not None and "data" in (a if isinstance(a, tuple) else (a,))
               for a in spec):
            assert moments[path].numel() * shape[0] * shape[1] >= g.numel() and \
                moments[path].numel() * shape[0] <= g.numel(), jk
    assert same >= 8
