"""The port's sharded paths against one device and against the JAX package.

Spec rules (``models/sharding.py``) are held equal to the JAX package's on
the same trees.  The sharded dispatch runs SPMD on gloo, on the CPU: each
mesh shape — ``(2, 1)``, ``(1, 2)``, ``(2, 2)``, in place of the JAX
suite's fake XLA devices — is one ``torch.multiprocessing`` spawn of its
ranks (``tests/_torch_sharding_worker.py``), which run every check and
hold each sharded call bitwise against the port's single-device call.
Here their outputs are held within ``1e-5`` of the JAX package's
single-device calls on the same weights (Pallas in interpret mode), and
the ranks' outputs equal to each other: every rank returns the global
result.  The gloo rendezvous is a ``file://`` store under ``tmp_path``.
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

import _torch_sharding_worker as worker
from repro.configs import alexnet_conv as jcfg
from repro.configs import get_config as jget_config
from repro.core import conv as jcv
from repro.core import params as jpar
from repro.models import cnn as jcnn
from repro.models import sharding as jsh
from repro.nn.attention import KVCache as JKVCache
from repro_torch.configs import get_config as tget_config
from repro_torch.core import conv as tcv
from repro_torch.core import params as tpar
from repro_torch.kernels import pas_histogram as ph
from repro_torch.kernels import pasm_matmul as pm
from repro_torch.launch.mesh import Mesh, n_shard_axis
from repro_torch.models import sharding as tsh
from repro_torch.nn.attention import KVCache as TKVCache

AX = {"data": 16, "model": 16}
TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = [(2, 1), (1, 2), (2, 2)]
JOIN_TIMEOUT_S = 240  # every check of one mesh, all ranks


def _z(*shape):
    return np.zeros(shape, np.float32)


def _both(tree_np):
    """The same numpy tree as JAX arrays and as torch tensors."""
    to_j = lambda t: {k: to_j(v) for k, v in t.items()} if isinstance(t, dict) \
        else jnp.asarray(t)
    to_t = lambda t: {k: to_t(v) for k, v in t.items()} if isinstance(t, dict) \
        else torch.from_numpy(t)
    return to_j(tree_np), to_t(tree_np)


def _same_spec(port, jax_spec):
    assert tuple(port) == tuple(jax_spec), (port, jax_spec)


# ---------------------------------------------------------------------------
# spec rules: the port's tables equal the JAX package's (tests/test_sharding.py)
# ---------------------------------------------------------------------------


def test_param_spec_rules():
    params = {
        "embed": _z(1600, 64),
        "layers": {
            "attn": {"wq": _z(2, 64, 256), "wo": _z(2, 256, 64)},
            "mlp": {"w1": _z(2, 64, 256), "w2": _z(2, 256, 64)},
            "attn_norm": _z(2, 64),
            "moe": {"w1": _z(2, 32, 64, 256), "router": _z(2, 64, 32)},
        },
        "lm_head": _z(64, 1600),
    }
    pj, pt = _both(params)
    sj, st = jsh.param_pspecs(pj, AX), tsh.param_pspecs(pt, AX)
    assert st["layers"]["moe"]["w1"] == tsh.P(None, "model", None, "data")
    for path in (("embed",), ("layers", "attn", "wq"), ("layers", "attn", "wo"),
                 ("layers", "mlp", "w1"), ("layers", "mlp", "w2"),
                 ("layers", "attn_norm"), ("layers", "moe", "w1"),
                 ("layers", "moe", "router"), ("lm_head",)):
        a, b = st, sj
        for k in path:
            a, b = a[k], b[k]
        _same_spec(a, b)


def test_indivisible_falls_back_to_replicated():
    pj, pt = _both({"attn": {"wq": _z(10, 24)}})  # 24 % 16 != 0
    st = tsh.param_pspecs(pt, AX)
    assert st["attn"]["wq"] == tsh.P(None, None)
    _same_spec(st["attn"]["wq"], jsh.param_pspecs(pj, AX)["attn"]["wq"])


def test_pasm_leaves_get_specs():
    """idx inherits the parent weight's layout, the codebook replicates:
    a stack of two weight-shared ``wq`` layers, shared and packed."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 16, (2, 64, 256)).astype(np.uint8)
    cb = rng.standard_normal((2, 1, 16)).astype(np.float32)
    ax = {"data": 2, "model": 2}
    for pack in (False, True):
        specs = []
        for pkg, arr in ((jpar, jnp.asarray), (tpar, torch.from_numpy)):
            w = pkg.PasmParams.shared(arr(idx), arr(cb))
            tree = {"layers": {"attn": {"wq": w.pack() if pack else w}}}
            sp = (jsh if pkg is jpar else tsh).param_pspecs(tree, ax)
            specs.append(sp["layers"]["attn"]["wq"])
        wj, wt = specs
        assert wt.idx == tsh.P(None, None, "model")
        assert wt.codebook == tsh.P(None, None, None)
        _same_spec(wt.idx, wj.idx)
        _same_spec(wt.codebook, wj.codebook)


def test_zero1_opt_specs_add_data():
    pj, pt = _both({"w1": _z(64, 256)})
    zt = tsh.opt_state_pspecs(pt, tsh.param_pspecs(pt, AX), AX)
    assert zt["w1"] == tsh.P("data", "model")
    _same_spec(zt["w1"], jsh.opt_state_pspecs(pj, jsh.param_pspecs(pj, AX), AX)["w1"])


def test_zero1_skips_already_data_sharded():
    pj, pt = _both({"moe": {"w1": _z(32, 64, 256)}})
    bt = tsh.param_pspecs(pt, AX)
    zt = tsh.opt_state_pspecs(pt, bt, AX)
    assert zt["moe"]["w1"] == bt["moe"]["w1"]
    bj = jsh.param_pspecs(pj, AX)
    _same_spec(zt["moe"]["w1"], jsh.opt_state_pspecs(pj, bj, AX)["moe"]["w1"])


@pytest.mark.parametrize("arch,kv", [("stablelm-3b", 32), ("qwen3-32b", 8)])
def test_cache_specs_kv_heads_vs_seq(arch, kv):
    """kv 32 divides 16: heads sharded; kv 8 does not: the sequence."""
    k = np.zeros((2, 8, 64, kv, 16), np.float32)
    pos = np.zeros((2,), np.int32)
    cj = {"scan": JKVCache(k=jnp.asarray(k), v=jnp.asarray(k), pos=jnp.asarray(pos))}
    ct = {"scan": TKVCache(k=torch.from_numpy(k), v=torch.from_numpy(k),
                           pos=torch.from_numpy(pos))}
    sj = jsh.cache_pspecs(jget_config(arch), cj, AX, ("data",))
    st = tsh.cache_pspecs(tget_config(arch), ct, AX, ("data",))
    _same_spec(st["scan"].k, sj["scan"].k)
    _same_spec(st["scan"].pos, sj["scan"].pos)


def test_batch_axes_adaptive():
    for args in ((False, 256), (True, 256), (False, 1), (True, 48)):
        assert tsh.batch_axes(*args) == jsh.batch_axes(*args)
    spec = {"tokens": torch.empty((8, 16), device="meta")}
    assert tsh.input_pspecs(spec, ("data",))["tokens"] == tsh.P("data", None)
    assert tsh.P(("pod", "data"), (), None) == (("pod", "data"), None, None)


def test_conv_param_pspec_rules():
    rng = np.random.default_rng(0)
    kern = rng.standard_normal((8, 4, 3, 3)).astype(np.float32)
    bias = np.zeros(8, np.float32)

    idx = rng.integers(0, 16, (8, 4, 3, 3)).astype(np.uint8)
    cb = np.linspace(-1, 1, 16).astype(np.float32)

    def tree(cv, arr, k7=False):
        k, b, i = (kern[:7], bias[:7], idx[:7]) if k7 else (kern, bias, idx)
        shared = lambda: cv.ConvParams.shared(arr(i), arr(cb), bias=arr(b))
        return {
            "conv": ([shared()] if k7 else [
                cv.ConvParams.dense(arr(k), bias=arr(b)), shared(),
                shared().pack()]),
            "head": {} if k7 else {"w": arr(np.zeros((32, 10), np.float32)),
                                   "b": arr(np.zeros(10, np.float32))},
        }

    ax = {"data": 4, "model": 2}
    for k7 in (False, True):
        sj = jsh.conv_param_pspecs(tree(jcv, jnp.asarray, k7), ax)
        st = tsh.conv_param_pspecs(tree(tcv, torch.from_numpy, k7), ax)
        for cj, ct in zip(sj["conv"], st["conv"]):
            for f in ("kernel", "idx", "codebook", "bias"):
                if getattr(ct, f) is not None and not isinstance(getattr(ct, f), torch.Tensor):
                    _same_spec(getattr(ct, f), getattr(cj, f))
        for f in st["head"]:
            _same_spec(st["head"][f], sj["head"][f])
    st = tsh.conv_param_pspecs(tree(tcv, torch.from_numpy), ax)
    assert st["conv"][2].idx == tsh.P(None, "model")  # packed: (Kp//2, c_out)
    assert st["conv"][1].idx == tsh.P("model", None, None, None)
    assert tsh.conv_input_pspecs() == tsh.P("data", None, None, None)
    _same_spec(tsh.conv_input_pspecs(), jsh.conv_input_pspecs())
    assert [tsh.conv_batch_pad(b, 4) for b in (6, 8)] == \
        [jsh.conv_batch_pad(b, 4) for b in (6, 8)] == [2, 0]


def test_local_shard_blocks_tile_the_tensor():
    """Every rank's block of a (2, 2) mesh, put back in coordinate order,
    is the global tensor (the specs' axis order: first axis outermost)."""
    t = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    spec = tsh.P(("data", "model"), None, "model")
    blocks = {}
    for d in range(2):
        for m in range(2):
            mesh = Mesh((2, 2), ("data", "model"), (d, m), (None, None),
                        torch.device("cpu"))
            blocks[d, m] = tsh.local_shard(t, spec, mesh)
    rows = [torch.cat([blocks[d, m] for m in range(2)], dim=2) for d in range(2)]
    assert torch.equal(rows[0][:, :, :2], t[0:2, :, :2])
    assert torch.equal(blocks[1, 1], t[6:8, :, 2:4])
    assert n_shard_axis(mesh, 6) == "model" and n_shard_axis(mesh, 7) is None
    with pytest.raises(ValueError, match="does not divide"):
        tsh.local_shard(t, tsh.P(None, None, ("data", "model", "data")), mesh)


@pytest.mark.parametrize("K,N", [(2304, 384), (3456, 384), (3456, 256)])
def test_shard_plans_the_whole_n(K, N):
    """conv3–conv5 on a model=2 shard: alone, N/2 would change K1's split
    count (conv3: 4 → 1); planned from the whole N it equals one device's."""
    M = 2 * 81
    one = pm.simt_plan(M, K, N)
    shard = pm.simt_plan(M, K, N // 2, whole=(M, N))
    assert shard.splits == one.splits > 1
    assert shard.cols <= one.cols and shard.blocks < one.blocks
    assert ph.pas_plan(M, K, N // 2, 16, whole=(M, N)).splits == \
        ph.pas_plan(M, K, N, 16).splits
    if K == 2304:
        assert pm.simt_plan(M, K, N // 2).splits == 1  # the shard's own N
    assert pm.k1_plan(4, K, N // 2, torch.bfloat16, whole=(24, N)).route == "mma"


# ---------------------------------------------------------------------------
# the sharded dispatch on gloo: one spawn a mesh shape
# ---------------------------------------------------------------------------


def _conv_tree(p):
    arr = lambda a: None if a is None else np.asarray(a)
    return dict(kind=p.kind, kshape=p.kshape, bins=p.bins, order=p.order,
                pad_k=p.pad_k, kernel=arr(p.kernel), idx=arr(p.idx),
                codebook=arr(p.codebook), bias=arr(p.bias))


def _jax_conv(x, params, conv, **kw):
    """JAX's single-device layer: its K1 kernel engine (``einsum`` for dense
    params), jitted, in interpret mode."""
    eng = "einsum" if params.kind == "dense" else "kernel"
    f = jax.jit(lambda x, p: jcv.conv2d(x, p, conv, engine=eng, interpret=True, **kw))
    return np.asarray(f(jnp.asarray(x), params))


def _dictionary(rng, kshape, bins, groups=1):
    """Seeded indices and a sorted dictionary at a conv's weight scale (the
    dispatch is under test, not k-means)."""
    scale = (kshape[1] * kshape[2] * kshape[3]) ** -0.5
    idx = jnp.asarray(rng.integers(0, bins, kshape).astype(np.uint8))
    cb = np.sort(rng.standard_normal((groups, bins)).astype(np.float32), -1) * scale
    return idx, jnp.asarray(cb[0] if groups == 1 else cb)


def _conv_case(conv_kw, x, kinds, pools=(None,)):
    """JAX's params for ``kinds`` (carried across as numpy) and its output
    for each kind and pool setting, keyed ``kind`` or ``kind/pool``.  JAX's
    engines agree with each other, so every port engine is held to this one
    reference."""
    conv = jcv.Conv2D(**conv_kw)
    rng = np.random.default_rng(conv.c_out + conv.c_in)
    kshape = (conv.c_out, conv.c_in, conv.ky, conv.kx)
    kern = rng.standard_normal(kshape).astype(np.float32) * conv.K ** -0.5
    kern, bias = jnp.asarray(kern), jnp.linspace(-0.5, 0.5, conv.c_out)
    shared = lambda: jcv.ConvParams.shared(*_dictionary(rng, kshape, 16), bias=bias)
    make = {
        "dense": lambda: jcv.ConvParams.dense(kern, bias=bias),
        "shared": shared,
        "packed": lambda: shared().pack(),
        "grouped": lambda: jcv.ConvParams.shared(
            *_dictionary(rng, kshape, 8, groups=3), bias=bias, order="ckk"),
    }
    params = {k: make[k]() for k in kinds}
    ref = {}
    for kind, p in params.items():
        for pool in pools:
            kw = {} if pool is None else dict(pool=pool)
            ref[kind if pool is None else f"{kind}/pool"] = _jax_conv(x, p, conv, **kw)
    return {"conv": conv_kw, "x": x,
            "params": {k: _conv_tree(p) for k, p in params.items()}}, ref


@pytest.fixture(scope="module")
def cases():
    """The inputs every rank gets, and the JAX package's outputs on them."""
    base = dict(k=3, c_in=5, c_out=8, stride=1, padding="same", relu=True)
    rng = np.random.default_rng(0)
    x8 = rng.standard_normal((8, 5, 13, 11)).astype(np.float32)
    data, refs = {}, {}
    data["kinds"], refs["kinds"] = _conv_case(base, x8, list(worker.ENGINES))
    nhwc = dict(k=3, c_in=6, c_out=16, stride=2, padding="same", layout="NHWC",
                relu=True)
    xn = rng.standard_normal((8, 13, 11, 6)).astype(np.float32)
    data["nhwc_stride"], refs["nhwc_stride"] = _conv_case(nhwc, xn, ["shared"])
    data["pool"], refs["pool"] = _conv_case(base, x8, ["shared"], pools=(2,))
    refs["pool"] = {"shared": refs["pool"]["shared/pool"]}
    data["uneven"], refs["uneven"] = _conv_case(base, x8[:5], ["shared"],
                                                pools=(None, 2))
    data["indivisible"], refs["indivisible"] = _conv_case(dict(base, c_out=7), x8,
                                                          ["shared"])
    data["refusals"] = data["indivisible"]

    cj = jcfg.smoke_config()
    feat = int(np.prod(jcnn.feature_shape(cj)))
    qj = {"conv": [jcv.ConvParams.shared(
              *_dictionary(rng, (c.c_out, c.c_in, c.ky, c.kx), cj.bins),
              bias=jnp.asarray(rng.standard_normal(c.c_out).astype(np.float32) * 0.1))
              for c, _ in jcnn.stages(cj)],
          "head": {"w": jnp.asarray(rng.standard_normal((feat, cj.classes)).astype(
                       np.float32) * feat ** -0.5),
                   "b": jnp.asarray(rng.standard_normal(cj.classes).astype(np.float32))}}
    imgs = rng.standard_normal((5, *cj.in_chw)).astype(np.float32)
    data["stack"] = {
        "cfg": {}, "impls": ("kernel", "kernel_implicit", "pas_kernel", "einsum",
                             "auto"), "x": imgs,
        "params": {"conv": [_conv_tree(p) for p in qj["conv"]],
                   "head": {k: np.asarray(v) for k, v in qj["head"].items()}}}
    fwd = jax.jit(lambda q, x: jcnn.forward(q, x, cj, interpret=True))
    refs["stack"] = {"logits": np.asarray(fwd(qj, jnp.asarray(imgs)))}

    xm = rng.standard_normal((7, 3, 40)).astype(np.float32)
    weights, mrefs = {}, {}
    for name, (K, N, pack) in {"shared": (40, 24, False), "packed": (39, 24, True),
                               "n7": (40, 7, False)}.items():
        idx = jnp.asarray(rng.integers(0, 16, (K, N)).astype(np.uint8))
        cb = jnp.asarray(np.sort(rng.standard_normal(16)).astype(np.float32) * 0.2)
        p = jpar.PasmParams.shared(idx, cb, bias=jnp.linspace(-1, 1, N))
        p = p.pack() if pack else p
        weights[name] = dict(idx=np.asarray(p.idx), codebook=np.asarray(p.codebook),
                             bias=np.asarray(p.bias), kind=p.kind, shape=p.shape,
                             bins=p.bins, pad_k=p.pad_k)
        for impl in ("kernel", "pas_kernel"):
            f = jax.jit(lambda x, p, impl=impl: jpar.matmul(
                x, p, impl=impl, relu=True, interpret=True))
            for dt in (jnp.float32, jnp.bfloat16):
                y = f(jnp.asarray(xm[..., :K]).astype(dt), p)
                mrefs[f"{name}/{impl}/{jnp.dtype(dt).name}"] = \
                    np.asarray(y.astype(jnp.float32))
    data["matmul"], refs["matmul"] = {"x": xm, "weights": weights}, mrefs

    layers = []
    for c_in, c_out in ((256, 384), (384, 384), (384, 256)):  # conv3–conv5
        layers.append({
            "conv": dict(k=3, c_in=c_in, c_out=c_out, relu=True),
            "idx": rng.integers(0, 16, (c_out, c_in, 3, 3)).astype(np.uint8),
            "codebook": (rng.standard_normal(16) * 0.05).astype(np.float32),
            "bias": rng.standard_normal(c_out).astype(np.float32),
            "x": rng.standard_normal((2, c_in, 5, 5)).astype(np.float32)})
    data["plans"] = {"layers": layers}
    return data, refs


@pytest.fixture(scope="module", params=MESHES, ids=lambda s: f"mesh{s[0]}x{s[1]}")
def ranks(request, cases, tmp_path_factory):
    """Run every check on one mesh shape: ``(shape, [each rank's results])``,
    a rank's results a dict: check → ("ok", outputs) or ("fail", traceback)."""
    shape = request.param
    world = shape[0] * shape[1]
    d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
    with open(d / "cases.pkl", "wb") as f:
        pickle.dump(cases[0], f)
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
    assert not any(p.is_alive() for p in ctx.processes)
    out = []
    for r in range(world):
        with open(d / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return shape, out


def _result(ranks, name: str) -> dict:
    """The check's outputs, after asserting it passed on every rank and that
    every rank returned the same global result."""
    _, ranks = ranks
    for r, res in enumerate(ranks):
        status, val = res[name]
        assert status == "ok", f"rank {r}, check {name}:\n{val}"
    first = ranks[0][name][1]
    for res in ranks[1:]:
        other = res[name][1]
        assert other.keys() == first.keys()
        for k in first:
            if isinstance(first[k], np.ndarray):
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)
    return first


def _close_to_jax(got: dict, refs: dict):
    """Every port output ``kind/engine[/pool]`` within TOL of JAX's
    ``kind[/pool]``."""
    for k, y in got.items():
        parts = k.split("/")
        want = refs["/".join([parts[0]] + parts[2:])]
        np.testing.assert_allclose(y, want, **TOL, err_msg=k)


def test_sharded_conv_all_kinds(ranks, cases):
    _close_to_jax(_result(ranks, "kinds"), cases[1]["kinds"])


def test_sharded_conv_nhwc_stride(ranks, cases):
    _close_to_jax(_result(ranks, "nhwc_stride"), cases[1]["nhwc_stride"])


def test_sharded_fused_pool_every_engine(ranks, cases):
    _close_to_jax(_result(ranks, "pool"), cases[1]["pool"])


def test_sharded_uneven_batch(ranks, cases):
    """B 5: zero images pad the batch to the data axis and are sliced off."""
    _close_to_jax(_result(ranks, "uneven"), cases[1]["uneven"])


def test_sharded_c_out_does_not_divide_model(ranks, cases):
    _close_to_jax(_result(ranks, "indivisible"), cases[1]["indivisible"])


def test_mesh_refusals(ranks):
    """The sharded conv's refusals (an unbatched image, ``pas_einsum``, not a
    mesh); compressed gradients, once refused, run on the mesh, each rank's
    block bitwise its block of the global compression."""
    from repro_torch.core import params as tpar

    got = _result(ranks, "refusals")
    assert "batched" in got["single"] and "pas_einsum" in got["pas_einsum"]
    assert "Mesh" in got["not_a_mesh"]
    assert got["compress_grads"] is True
    assert not [n for n in dir(tpar) if n.startswith("NOT_PORTED")]


def test_sharded_cnn_stack(ranks, cases):
    """The smoke AlexNet with every conv idx and bias leaf and the head
    sharded over ``model``: bitwise one device's logits on every engine
    (in the ranks), within 1e-5 of JAX's; each rank's weight bytes shrink
    with ``model``."""
    got = _result(ranks, "stack")
    for k, y in got.items():
        if k not in ("bytes", "dense"):  # forward_dense: the port's own weights
            np.testing.assert_allclose(y, cases[1]["stack"]["logits"], **TOL,
                                       err_msg=k)
    full, local = got["bytes"]
    if ranks[0][1] == 1:
        assert local == full
    else:  # idx, bias and head halve; the codebooks (16 floats a layer) stay
        assert full / 2 < local < full / 2 + 3 * 16 * 4 + 1


def test_sharded_params_matmul(ranks, cases):
    """params.matmul(mesh=) on K1 and K3: f32 within TOL of JAX's, bf16
    within one bf16 ulp (both round an f32 sum taken in another order)."""
    got = _result(ranks, "matmul")
    assert got.keys() == cases[1]["matmul"].keys()
    for k, y in got.items():
        tol = TOL if k.endswith("float32") else dict(rtol=2.0 ** -8, atol=1e-5)
        np.testing.assert_allclose(y, cases[1]["matmul"][k], **tol, err_msg=k)


def test_sharded_split_k_plans(ranks):
    """conv3–conv5 split K on a model shard at the single-device count
    (the ranks assert equality with the single-device plans; K1: 4, 6, 6)."""
    plans = _result(ranks, "plans")["plans"]
    simt = [s for kind, _, s in plans if kind == "simt"]
    assert simt[:2] == [4, 4] and simt[2:4] == [6, 6] and simt[4:6] == [6, 6]
