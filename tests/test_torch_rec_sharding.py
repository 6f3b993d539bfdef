"""Tensor parallelism of the SSM, hybrid and encoder-decoder families, and
the sequence-sharded KV cache, against one device and against the JAX
package, on the CPU.

An active ``ShardCtx`` runs ``forward``/``prefill``/``decode_step`` of
mamba2-130m, recurrentgemma-2b and whisper-tiny, and of phi3-medium-14b
(its 5 smoke KV heads do not divide ``model`` 2: q, k and v are gathered
whole and the KV cache's positions split over ``model``), SPMD, one
process a rank, on params placed by ``models/sharding.py::place_params``
and caches by ``place_caches``.  Each mesh shape — ``(2, 1)``, ``(1, 2)``,
``(2, 2)`` — is one ``torch.multiprocessing`` spawn of gloo ranks
(``tests/_torch_rec_sharding_worker.py``) running the smoke configs on
``dequant``, ``kernel`` and ``pas_kernel`` (phi3 also on the int8 KV
cache): forward, a prefill (right-padded for whisper and phi3; the
recurrent scans take no padded prompt, in both packages) and 3 decode
steps, and recurrentgemma a 22-token prompt past its 16-slot ring whose 3
steps write slots 6–8, across both ranks' halves of the ring.

What is bitwise and what is held to a tolerance:
- bitwise one device's: mesh (1, 1) (in one process) and every mesh with
  no ``model`` split, ``(2, 1)`` (each rank's batch rows: every product a
  row block of one device's);
- within ``LOGIT_TOL`` (2.5 % of max |logit|; the hybrid's 8 %: its
  RG-LRU gates amplify bf16 noise, ``tests/test_torch_hybrid.py``) of one
  device's logits with a ``model`` split: the row-parallel sums add their
  f32 partials in another order, and the sequence-sharded softmax folds
  its partials instead of normalising once; the caches, gathered back,
  within the same bound, their counters exactly;
- against the JAX package's unsharded forward, prefill and decode steps on
  the same weights (carried across with ``tests/_torch_lm.py``): within
  the same bounds.

In one process: placed leaves and caches against JAX's ``param_pspecs`` /
``cache_pspecs`` blocks, leaf by leaf; the rank-order softmax combine;
the SSD scan on P blocks; (1, 1) bitwise.
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

import _torch_heads
import _torch_rec_sharding_worker as worker
from _torch_lm import _key, tree_to_numpy
from repro import configs as jconfigs
from repro.models import api as japi
from repro.models import common as jcommon
from repro.models import encdec as JE
from repro.models import sharding as jsh
from repro_torch import interop
from repro_torch.launch.mesh import Mesh, make_conv_mesh
from repro_torch.models import api as tapi
from repro_torch.models import common as tcommon
from repro_torch.models import sharding as tsh
from repro_torch.nn import attention as TA
from repro_torch.nn import ssm as TSSM
from repro_torch.tree import flatten_with_path, tree_unflatten

ARCHS = worker.ARCHS
MESHES = [(2, 1), (1, 2), (2, 2)]
JOIN_TIMEOUT_S = 240  # every check of one mesh, all ranks
B, S, STEPS, MAX_SEQ = 4, 11, 3, 32
LONG = 22  # recurrentgemma: past its 16-slot ring; the steps write slots 6-8
LENGTHS = np.array([S, 6, 9, 3], np.int32)


def _cpu_mesh(shape, coords) -> Mesh:
    """One rank's view of a mesh with no process groups: placement needs
    none."""
    return Mesh(tuple(shape), ("data", "model"), tuple(coords), (None, None),
                torch.device("cpu"))


def _jcfg(arch: str):
    base, changes = worker.VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(jconfigs.get_config(base, smoke=True), **changes).with_quant(
        enabled=True, min_weight_elems=1024, impl="dequant")


def _jparams(arch: str, jc):
    m = japi.get_model(jc)

    def init(k):
        p = jcommon.quantize_params(m.init_params(jc, k), jc)
        return JE.quantize_frontend(p, bins=16) if jc.family == "audio" else p

    return jax.jit(init)(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def cases():
    """The JAX weights (quantized by the JAX package, the whisper stem by
    its ``quantize_frontend``; jitted), every rank's inputs, and the JAX
    package's unsharded forward, prefill and decode logits on ``dequant``."""
    data, refs = {}, {}
    rng = np.random.default_rng(11)
    for arch in ARCHS + ("qwen3-32b",):
        jc = _jcfg(arch)
        m = japi.get_model(jc)
        jp = _jparams(arch, jc)
        c = {"params": tree_to_numpy(jp), "max_seq": MAX_SEQ, "mel": None, "long": None,
             "toks": rng.integers(0, jc.vocab, (B, S)).astype(np.int32),
             "lengths": LENGTHS,
             "nxt": rng.integers(0, jc.vocab, (STEPS, B, 1)).astype(np.int32)}
        if jc.family == "audio":
            c["mel"] = rng.standard_normal((B, jc.n_mels, 2 * jc.frontend_tokens)).astype(
                np.float32)
        if jc.family == "hybrid":
            c["long"] = rng.integers(0, jc.vocab, (B, LONG)).astype(np.int32)
            c["long_nxt"] = rng.integers(0, jc.vocab, (STEPS, B, 1)).astype(np.int32)
        kw = {} if c["mel"] is None else {"frontend_embeds": jnp.asarray(c["mel"])}
        f32 = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
        ref = {"fwd": f32(jax.jit(lambda p, t, kw: m.forward(p, t, jc, **kw)[0])(
            jp, jnp.asarray(c["toks"]), kw))}
        pre = jax.jit(lambda p, t, cc, kw: m.prefill(p, t, cc, jc, **kw))
        dec = jax.jit(lambda p, t, cc: m.decode_step(p, t, cc, jc))
        runs = [("pre", "dec", c["toks"], c["nxt"])]
        if c["long"] is not None:
            runs.append(("long", "long_dec", c["long"], c["long_nxt"]))
        for key, dkey, toks, nxt in runs:
            pkw = dict(kw)
            if worker.padded(arch):
                pkw["lengths"] = jnp.asarray(LENGTHS)
            logits, cache = pre(jp, jnp.asarray(toks),
                                m.init_caches(jc, toks.shape[0], MAX_SEQ), pkw)
            ref[key], ref[dkey] = f32(logits), []
            for step in nxt:
                logits, cache = dec(jp, jnp.asarray(step), cache)
                ref[dkey].append(f32(logits))
        data[arch], refs[arch] = c, ref
    # the variant whose heads model cuts: the port's own weights, whisper's inputs
    data[worker.CUT] = dict(data["whisper-tiny"], params=None)
    return data, refs


def _spawn(shape, data: dict, tmp_path_factory):
    """Every check on one mesh shape over the archs of ``data``: ``(shape,
    [each rank's results])``, a rank's results a dict: check → (status,
    outputs, collective bytes)."""
    world = shape[0] * shape[1]
    d = tmp_path_factory.mktemp(f"rec{shape[0]}x{shape[1]}")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(data, f)
    ctx = tmp.start_processes(
        worker.run, args=(world, shape, str(d / "store"), str(d / "cases.pkl"), str(d)),
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
    return shape, out


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def ranks(request, cases, tmp_path_factory):
    """Every arch of ``ARCHS`` (and the one-head whisper) on one mesh shape."""
    data = {a: c for a, c in cases[0].items() if a in ARCHS + (worker.CUT,)}
    return _spawn(request.param, data, tmp_path_factory)


@pytest.fixture(scope="module")
def ranks4(cases, tmp_path_factory):
    """The archs of ``worker.FOUR`` on four ranks of ``model``."""
    return _spawn((1, 4), {a: cases[0][a] for a in worker.FOUR}, tmp_path_factory)


def _assert_heads(ranks, arch: str) -> None:
    """Each rank's head block and the heads its attention calls ran on
    (``models/common.py::head_block``): GSPMD's ``gcd(n_heads, model)``
    blocks, ``tests/_torch_heads.py::HEADS``."""
    shape, res = ranks
    tc = worker.smoke_config(arch)
    for r, rr in enumerate(res):
        (q0, nq), seen = rr["families"][1]["heads"][arch]
        w0, wn, wkv = _torch_heads.want(tc.n_heads, tc.n_kv_heads, shape[1], r % shape[1])
        assert (q0, nq) == (w0, wn), (shape, r, arch, (q0, nq))
        assert seen == [(wn, wkv)], (shape, r, arch, seen)


def _result(ranks, name: str):
    """Every rank's outputs of a check, after asserting it passed on every
    rank and moved bytes through a collective."""
    _, res = ranks
    for r, rr in enumerate(res):
        status, val, nbytes = rr[name]
        assert status == "ok", f"rank {r}, check {name}:\n{val}"
        assert sum(nbytes.values()) > 0
    return [rr[name][1] for rr in res], [rr[name][2] for rr in res]


def test_heads_cut_by_model_gather_and_split_the_caches(ranks):
    """whisper with one head at ``model`` 2: q, k and v gathered whole, its
    self- and cross-attention caches' positions split over ``model``
    (combined in rank order at decode); the ranks held every call and the
    gathered caches to one device (bitwise at (2, 1)); here every rank
    returns the same logits, and a ``model`` split combined partials."""
    shape, _ = ranks
    outs, nbytes = _result(ranks, "families")
    for o in outs[1:]:
        for combo, r in outs[0][worker.CUT].items():
            np.testing.assert_array_equal(o[worker.CUT][combo]["dec"], r["dec"])
    if shape[1] > 1:
        assert nbytes[0]["softmax_combine"] > 0 and nbytes[0]["relayout"] > 0


def _hold_family(ranks, cases, arch: str) -> None:
    """Every rank's global logits the same bits, and the ``dequant`` logits
    within the arch's tolerance of the JAX package's unsharded calls."""
    outs, _ = _result(ranks, "families")
    first = outs[0][arch]
    for o in outs[1:]:  # every rank returns the global result
        for combo, r in first.items():
            for key, v in r.items():
                if key != "errs":
                    np.testing.assert_array_equal(np.asarray(o[arch][combo][key]),
                                                  np.asarray(v), err_msg=f"{combo} {key}")
    got, ref, limit = first["dequant", 16], cases[1][arch], worker.tol(arch)
    for key, want in ref.items():
        ws = want if isinstance(want, list) else [want]
        gs = got[key] if isinstance(want, list) else [got[key]]
        for i, (g, w) in enumerate(zip(gs, ws)):
            assert g.shape == w.shape, (key, g.shape, w.shape)
            d = np.abs(g - w).max()
            assert d <= limit * np.abs(w).max(), (key, i, d, np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_matches_one_device_and_jax(ranks, cases, arch):
    """forward, prefill and 3 decode steps (and the hybrid's wrapped ring)
    under every mesh: the ranks held each call and the gathered caches
    against one device (bitwise at (2, 1)); here every rank's global logits
    are the same bits, a ``model`` split moved activations under the keys
    the layouts name, and the ``dequant`` logits agree with the JAX
    package's unsharded calls.  The hybrid's one KV head and the 6-head
    qwen3 variant's 3 (a rank's 3 q heads straddle a KV group) do not
    divide ``model`` 2: each rank ran attention on its own block of q
    heads."""
    shape, _ = ranks
    _, nbytes = _result(ranks, "families")
    if shape[1] > 1:
        assert nbytes[0]["relayout"] > 0 and nbytes[0]["all_reduce"] > 0
        # phi3's KV cache and the hybrid's ring split their positions
        assert nbytes[0]["softmax_combine"] > 0
    if shape[0] > 1:  # the recurrent states are whole on the batch
        assert nbytes[0]["cache_rows"] > 0
    _hold_family(ranks, cases, arch)
    if arch in ("recurrentgemma-2b", worker.STRADDLE):
        _assert_heads(ranks, arch)


@pytest.mark.parametrize("arch", worker.FOUR)
def test_q_heads_split_by_gcd_at_model_4(ranks4, cases, arch):
    """At (1, 4), where 2 or 3 KV heads do not divide ``model``: qwen3's
    smoke runs one q head a rank (half a KV group), the 6-head variant a
    block of 3 on two ranks each, which take disjoint K rows of ``wo``.
    The ranks held forward, prefill and 3 decode steps and the gathered
    caches against one device; every rank's logits are the same bits,
    within 2.5 % of the JAX package's; each rank's attention ran on its
    block; the KV cache split its positions and decode combined them."""
    _, nbytes = _result(ranks4, "families")
    assert nbytes[0]["softmax_combine"] > 0 and nbytes[0]["relayout"] > 0
    _hold_family(ranks4, cases, arch)
    _assert_heads(ranks4, arch)


# ---------------------------------------------------------------------------
# in one process: placement, the softmax combine, the SSD scan, (1, 1)
# ---------------------------------------------------------------------------


_STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def _port_path(path: tuple) -> str:
    """A port leaf's path as the JAX tree names it: no per-layer (per-group)
    index where JAX stacks them, no ``w`` of a dense leaf placed as a block."""
    path = [p for i, p in enumerate(path) if not (i and path[i - 1] in _STACKED)]
    return "/".join(path[:-1] if path[-1] == "w" else path)


def _flat_specs(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(_key(p) for p in path): tuple(s) for path, s in flat}


def _block_shape(shape, spec, sizes) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(d // int(np.prod([sizes[a] for a in ((ax,) if isinstance(ax, str) else ax)]))
                 if ax else d for d, ax in zip(shape, spec))


def _jax_tree(t):
    """A numpy tree from :func:`tree_to_numpy` back to JAX containers."""
    from repro.core.conv import ConvParams
    from repro.core.params import PasmParams

    if isinstance(t, dict) and "kshape" in t:
        arr = {f: None if t[f] is None else jnp.asarray(t[f])
               for f in ("kernel", "idx", "codebook", "bias")}
        return ConvParams(**arr, kind=t["kind"], kshape=tuple(t["kshape"]), bins=t["bins"],
                          order=t["order"], pad_k=t["pad_k"])
    if isinstance(t, dict) and "kind" in t:
        arr = {f: None if t[f] is None else jnp.asarray(t[f])
               for f in ("w", "idx", "codebook", "bias")}
        return PasmParams(**arr, kind=t["kind"], shape=tuple(t["shape"]), bins=t["bins"],
                          pad_k=t["pad_k"])
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, list):
        return [_jax_tree(v) for v in t]
    return jnp.asarray(t)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_leaves_follow_jax_param_pspecs(cases, arch):
    """Every leaf ``place_params`` gives a rank is the block JAX's
    ``param_pspecs`` names for it, on every coordinate of every mesh: the
    recurrent and conv channels, ``in_proj``/``rec_in``/``w_a``/``w_x``
    columns, ``out_proj``/``rec_out`` rows, ``ssm_norm``/``lam``/``b_a``/
    ``b_x``, the whisper stem whole; each block the global leaf's slice."""
    tree = cases[0][arch]["params"]
    jp, tp = _jax_tree(tree), interop.lm_params_from_numpy(tree, device="cpu")
    glob = {"/".join(p): leaf for p, leaf in flatten_with_path(tp)}
    for shape in MESHES:
        sizes = dict(zip(("data", "model"), shape))
        spec = _flat_specs(jsh.param_pspecs(jp, sizes))
        for coords in np.ndindex(*shape):
            mesh = _cpu_mesh(shape, coords)
            placed = tsh.place_params(tp, mesh)
            n_split = 0
            for path, leaf in flatten_with_path(placed):
                key = _port_path(path)
                g = glob.get("/".join(path), glob.get("/".join(path[:-1])))
                s = spec[key][-leaf.ndim:] if leaf.ndim else ()
                assert tuple(leaf.shape) == _block_shape(g.shape, s, sizes), (shape, key)
                s = tuple(s) + (None,) * (leaf.ndim - len(s))
                assert torch.equal(leaf, tsh.local_shard(g, tsh.P(*s), mesh)), (shape, key)
                n_split += tuple(leaf.shape) != tuple(g.shape)
            if shape == (1, 2):  # every family splits its mixers and its head
                assert n_split >= 8, (arch, n_split)


@pytest.mark.parametrize("arch", ARCHS)
def test_placed_caches_follow_jax_cache_pspecs(arch):
    """``place_caches`` gives each rank the block JAX's ``cache_pspecs``
    names on every coordinate of every mesh: the SSD state's P, the conv
    windows' and RG-LRU states' channels, KV heads over ``model`` where
    they divide it (whisper) and else the positions (phi3's 5 heads, the
    hybrid's one-head ring), which the cache records (``seq_shards``);
    ``gather_caches`` puts the blocks back."""
    jc, tc = _jcfg(arch), worker.smoke_config(arch)
    jm, tm = japi.get_model(jc), tapi.get_model(tc)
    jcache = jm.init_caches(jc, B, MAX_SEQ)
    tcache = tm.init_caches(tc, B, MAX_SEQ, device="cpu")
    filled = [(p, torch.randn(leaf.shape).to(leaf.dtype) if leaf.is_floating_point()
               else torch.randint(-1, 9, leaf.shape, dtype=leaf.dtype))
              for p, leaf in flatten_with_path(tcache)]
    tcache = tree_unflatten(tcache, [leaf for _, leaf in filled])
    for shape in MESHES:
        sizes = dict(zip(("data", "model"), shape))
        batch = jsh.batch_axes(False, B, shape[0])
        spec = _flat_specs(jsh.cache_pspecs(jc, jcache, sizes, batch))
        on_model = {k for k, s in spec.items() if "model" in s}
        for coords in np.ndindex(*shape):
            mesh = _cpu_mesh(shape, coords)
            placed = tsh.place_caches(tc, tcache, mesh, batch)
            for (path, leaf), (_, g) in zip(flatten_with_path(placed), filled):
                key = _cache_path(path)
                s = spec[key][-leaf.ndim:]
                assert tuple(leaf.shape) == _block_shape(g.shape, s, sizes), (shape, key)
                s = tuple(s) + (None,) * (leaf.ndim - len(s))
                assert torch.equal(leaf, tsh.local_shard(g, tsh.P(*s), mesh)), (shape, key)
            seq = {c.seq_shards for c in _kv_caches(placed)}
            if arch in ("phi3-medium-14b", "recurrentgemma-2b"):  # one head / 5 heads
                assert seq <= {shape[1] if arch == "phi3-medium-14b" else 1}, (shape, seq)
        # a state's channels, P, heads or positions lie on model
        assert on_model, shape


def _cache_path(path: tuple) -> str:
    """A port cache leaf's path as the JAX cache tree names it: JAX stacks
    the per-layer (per-group) caches, and mamba's has no ``layers`` key."""
    path = [p for i, p in enumerate(path)
            if not (p.isdigit() and (i == 0 or path[i - 1] in _STACKED + ("scan",)))]
    return "/".join(path[1:] if path[0] == "layers" else path)


def _kv_caches(tree) -> list:
    if isinstance(tree, (TA.KVCache, TA.QuantKVCache)):
        return [tree]
    if isinstance(tree, dict):
        return [c for v in tree.values() for c in _kv_caches(v)]
    if isinstance(tree, list):
        return [c for v in tree for c in _kv_caches(v)]
    return []


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_softmax_combine_rank_order(tp):
    """The sequence-sharded decode softmax: each block's ``(m, l, o)``
    (``softmax_partial``) folded in rank order (``combine_partials``)
    within 1e-5 of the unsharded f32 softmax, including a block with no
    valid position; at tp 1 ``decode_attention`` (and the int8 cache's) on
    a cache of one shard is the unsharded function, bitwise."""
    rng = np.random.default_rng(tp)
    Bq, KV, G, Sk, hd = 3, 2, 2, 16, 8
    q = torch.from_numpy(rng.standard_normal((Bq, 1, KV * G, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((Bq, Sk, KV, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((Bq, Sk, KV, hd)).astype(np.float32))
    pos = torch.tensor([Sk, 5, 9], dtype=torch.int32)  # row 1: the last block empty
    cache = TA.KVCache(k=k, v=v, pos=pos)
    want = TA.decode_attention(q, cache)
    s = torch.einsum("bkgd,bskd->bkgs", q.reshape(Bq, KV, G, hd), k) * hd ** -0.5
    valid = torch.arange(Sk)[None, :] < pos[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30))
    n = Sk // tp
    parts = [TA.softmax_partial(s[..., r * n:(r + 1) * n], v[:, r * n:(r + 1) * n])
             for r in range(tp)]
    got = TA.combine_partials(parts).reshape(Bq, 1, KV * G, hd)
    assert (got - want).abs().max() <= 1e-5 * max(1.0, float(want.abs().max()))
    mesh = make_conv_mesh((1, 1), device="cpu")
    assert torch.equal(TA.decode_attention(q, cache, mesh=mesh), want)
    qc = TA.update_quant_cache(TA.init_quant_kv_cache(Bq, Sk, KV, hd), k, v)
    qc = dataclasses.replace(qc, pos=pos)
    assert torch.equal(TA.decode_attention_quant(q, qc, mesh=mesh),
                       TA.decode_attention_quant(q, qc))


@pytest.mark.parametrize("tp", [2, 4])
def test_ssd_scan_is_local_to_a_p_block(tp):
    """The SSD scan and its decode step on a rank's block of head_dim P
    (whole B, C, dt) give the whole call's block: each (head, p) channel is
    its own recurrence, so the state and output blocks are the whole
    call's (within one f32 rounding: the batched products take other
    shapes)."""
    rng = np.random.default_rng(tp)
    Bq, Sq, H, P, N = 2, 12, 4, 8, 6
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x, Bm, Cm = t(Bq, Sq, H, P), t(Bq, Sq, 1, N), t(Bq, Sq, 1, N)
    dt, A, D = t(Bq, Sq, H).abs() * 0.1, -t(H).abs(), t(H)
    y, h = TSSM.ssd_scan(x, dt, A, Bm, Cm, D, chunk=4)
    ys, hs = TSSM.ssd_decode_step(x[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D, h)
    w = P // tp
    for r in range(tp):
        blk = slice(r * w, (r + 1) * w)
        yb, hb = TSSM.ssd_scan(x[..., blk], dt, A, Bm, Cm, D, chunk=4)
        torch.testing.assert_close(yb, y[..., blk], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hb, h[:, :, blk], rtol=1e-6, atol=1e-6)
        yd, hd_ = TSSM.ssd_decode_step(x[:, 0, :, blk], dt[:, 0], A, Bm[:, 0], Cm[:, 0], D,
                                       h[:, :, blk])
        torch.testing.assert_close(yd, ys[..., blk], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(hd_, hs[:, :, blk], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_1x1_is_bitwise_the_unsharded_calls(arch):
    """An active context on the (1, 1) mesh (no process group) computes the
    one-device function bitwise: forward, prefill, decode."""
    mesh = make_conv_mesh((1, 1), device="cpu")
    tc = worker.smoke_config(arch, impl="kernel")
    m = tapi.get_model(tc)
    params = tcommon.quantize_params(m.init_params(tc, torch.Generator().manual_seed(1)),
                                     tc, iters=2)
    sctx = tcommon.ShardCtx.for_mesh(mesh, 2)
    placed = tsh.place_params(params, mesh)
    g = torch.Generator().manual_seed(2)
    toks = torch.randint(0, tc.vocab, (2, 7), generator=g)
    kw = {}
    if tc.family == "audio":
        kw["frontend_embeds"] = torch.randn((2, tc.n_mels, 2 * tc.frontend_tokens),
                                            generator=g)
    assert torch.equal(m.forward(params, toks, tc, **kw)[0],
                       m.forward(placed, toks, tc, sctx, **kw)[0])
    ca = m.init_caches(tc, 2, 16, device="cpu")
    cb = tsh.place_caches(tc, m.init_caches(tc, 2, 16, device="cpu"), mesh, sctx.batch)
    a, ca = m.prefill(params, toks, ca, tc, **kw)
    b, cb = m.prefill(placed, toks, cb, tc, sctx, **kw)
    assert torch.equal(a, b)
    for t in range(2):
        a, ca = m.decode_step(params, toks[:, t:t + 1], ca, tc)
        b, cb = m.decode_step(placed, toks[:, t:t + 1], cb, tc, sctx)
        assert torch.equal(a, b)
    for (p, x), (_, y) in zip(flatten_with_path(ca), flatten_with_path(cb)):
        assert torch.equal(x, y), p
