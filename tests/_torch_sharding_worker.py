"""The ranks of ``tests/test_torch_sharding.py``: one process a rank on gloo.

Each rank builds the mesh, runs every check on the CPU and writes what each
check returned (or its traceback) to ``rank<r>.pkl``.  A check holds the
sharded call bitwise against the single-device call, computed in the same
process, and returns the sharded outputs, which the parent holds against
the JAX package.  No JAX here: the parent computed the JAX side and handed
its weights and inputs over as numpy (``cases.pkl``).

One thread a rank: the plain CPU path's products are MKL's, whose threaded
kernels split K by the shape, so a row block could sum in another order
than the whole product; single-threaded they do not.  (On the card the
kernels plan from the whole call's shape instead.)  A failing check is
recorded, not raised, so the ranks stay in step through the collectives.
"""
from __future__ import annotations

import dataclasses
import pickle
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import interop
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.core import conv as cv
from repro_torch.core import params as par
from repro_torch.kernels import pas_histogram as ph
from repro_torch.kernels import pasm_matmul as pm
from repro_torch.launch.mesh import make_conv_mesh
from repro_torch.models import cnn
from repro_torch.models import sharding as tsh
from repro_torch.train import optimizer as topt
from repro_torch.tree import flatten_with_path, tree_leaves

COLLECTIVE_TIMEOUT_S = 30  # a rank out of step fails fast instead of hanging

ENGINES = {
    "dense": ("einsum",),
    "shared": ("kernel", "kernel_implicit", "pas_kernel", "pas_kernel_implicit",
               "einsum", "auto"),
    "packed": ("kernel", "kernel_implicit", "pas_kernel"),
    "grouped": ("kernel", "kernel_implicit"),
}
KERNEL_ENGINES = ("kernel", "kernel_implicit", "pas_kernel", "pas_kernel_implicit")


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(d):
    return interop.conv_params_from_numpy(d, device="cpu")


def _same(got, want, what: str):
    if got.shape != want.shape or not torch.equal(got, want):
        d = (got - want).abs().max() if got.shape == want.shape else None
        raise AssertionError(f"{what}: sharded != single device "
                             f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
                             f"max |Δ| {d})")
    return got.numpy()


def _conv_pairs(mesh, case, engines_of, **kw):
    """conv2d on one device and under ``mesh`` for every (params, engine)."""
    out = {}
    x = _t(case["x"])
    conv = cv.Conv2D(**case["conv"])
    for kind, d in case["params"].items():
        p = _params(d)
        for eng in engines_of[kind]:
            want = cv.conv2d(x, p, conv, engine=eng, **kw)
            got = cv.conv2d(x, p, conv, engine=eng, mesh=mesh, **kw)
            out[f"{kind}/{eng}"] = _same(got, want, f"{kind}/{eng}")
    return out


def check_kinds(mesh, case):
    return _conv_pairs(mesh, case, ENGINES)


def check_nhwc_stride(mesh, case):
    return _conv_pairs(mesh, case, {"shared": KERNEL_ENGINES + ("einsum",)})


def check_pool(mesh, case):
    return _conv_pairs(mesh, case, {"shared": KERNEL_ENGINES}, pool=2,
                       pool_impl="fused")


def check_uneven(mesh, case):
    """B 6 on every data size: the pad images never change a real row."""
    out = _conv_pairs(mesh, case, {"shared": KERNEL_ENGINES + ("einsum",)})
    pooled = _conv_pairs(mesh, case, {"shared": KERNEL_ENGINES}, pool=2)
    out.update({k + "/pool": v for k, v in pooled.items()})
    return out


def check_indivisible(mesh, case):
    """c_out 7 on any model size: the weights replicate, data still splits."""
    return _conv_pairs(mesh, case, {"shared": ("kernel", "kernel_implicit",
                                               "pas_kernel", "pas_kernel_implicit")})


def check_refusals(mesh, case):
    x = _t(case["x"])
    conv = cv.Conv2D(**case["conv"])
    p = _params(case["params"]["shared"])
    raised = {}
    for what, call, err in (
        ("single", lambda: cv.conv2d(x[0], p, conv, engine="kernel", mesh=mesh),
         ValueError),
        ("pas_einsum", lambda: cv.conv2d(x, p, conv, engine="pas_einsum", mesh=mesh),
         ValueError),
        ("not_a_mesh", lambda: cv.conv2d(x, p, conv, engine="kernel", mesh=object()),
         TypeError),
    ):
        try:
            call()
        except err as e:
            raised[what] = str(e)
        else:
            raise AssertionError(f"{what}: no {err.__name__}")
    # sharded QAT trains (tests/test_torch_train_sharding.py), and compressed
    # gradients under a mesh run: a rank's block of a (data, model)-split
    # leaf compresses with the whole leaf's max |g|, bitwise its block of
    # the global compression
    g = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 6)).astype(np.float32))
    spec = tsh.P("data", "model")
    axes = tuple(a for a in ("data", "model") if mesh.size(a) > 1)
    got = topt.compress_grads({"w": tsh.local_shard(g, spec, mesh).clone()}, 16, mesh=mesh,
                              block_axes={("w",): axes})["w"]
    want = tsh.local_shard(topt.compress_grads({"w": g}, 16)["w"], spec, mesh)
    raised["compress_grads"] = bool(torch.equal(got, want))
    return raised


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def check_stack(mesh, case):
    """The smoke AlexNet: every conv idx and bias leaf and the head really
    sharded over ``model``, the forward bitwise on every engine."""
    cfg = dataclasses.replace(tcfg.smoke_config(), **case["cfg"])
    qp = interop.cnn_params_from_numpy(case["params"], device="cpu")
    qpm = cnn._place(qp, mesh)
    nm = mesh.size("model")
    for i, (g, s) in enumerate(zip(qp["conv"], qpm["conv"])):
        n_dim = 1 if g.kind == "packed" else 0
        if s.idx.shape[n_dim] * nm != g.idx.shape[n_dim] or \
                s.bias.shape[0] * nm != g.bias.shape[0] or \
                not torch.equal(s.codebook, g.codebook) or s.kshape != g.kshape:
            raise AssertionError(f"conv {i}: not placed on model ({nm})")
    if qpm["head"]["w"].shape[1] * nm != qp["head"]["w"].shape[1]:
        raise AssertionError("head not placed on model")
    imgs = _t(case["x"])
    out = {"bytes": (_nbytes(qp), _nbytes(qpm))}
    for impl in case["impls"]:
        c = dataclasses.replace(cfg, impl=impl)
        want = cnn.forward(qp, imgs, c)
        out[impl] = _same(cnn.forward(qpm, imgs, c, mesh=mesh), want, impl)
        # the global weights under a mesh give the same logits
        _same(cnn.forward(qp, imgs, c, mesh=mesh), want, impl + " global")
    # the port's own quantize(mesh=) is quantize() then the placement
    dense = cnn.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    a, b = cnn.quantize(dense, cfg, iters=2, mesh=mesh), \
        cnn._place(cnn.quantize(dense, cfg, iters=2), mesh)
    for (pa, la), (pb, lb) in zip(flatten_with_path(a), flatten_with_path(b)):
        if pa != pb or not torch.equal(la, lb):
            raise AssertionError(f"quantize(mesh=) differs at {pa}")
    want = cnn.forward_dense(dense, imgs, cfg)
    out["dense"] = _same(cnn.forward_dense(dense, imgs, cfg, mesh=mesh), want,
                         "forward_dense")
    return out


def check_matmul(mesh, case):
    """params.matmul(mesh=) on K1 and K3, f32 and bf16 x, its 21 rows
    padded to the data axis."""
    out = {}
    for name, d in case["weights"].items():
        x = _t(case["x"][..., :d["shape"][0]])
        w = par.PasmParams(idx=_t(d["idx"]), codebook=_t(d["codebook"]),
                           bias=_t(d["bias"]), kind=d["kind"],
                           shape=tuple(d["shape"]), bins=d["bins"],
                           pad_k=d["pad_k"])
        for impl in ("kernel", "pas_kernel"):
            for xx in (x, x.to(torch.bfloat16)):
                what = f"{name}/{impl}/{str(xx.dtype)[6:]}"  # torch.<dtype>
                want = par.matmul(xx, w, impl=impl, relu=True)
                got = par.matmul(xx, w, impl=impl, relu=True, mesh=mesh)
                _same(got.float(), want.float(), what)
                out[what] = got.float().numpy()
    return out


def check_plans(mesh, case):
    """conv3–conv5's split-K on a model shard equals the single-device
    count: the kernels plan from the whole call's N."""
    rec = []
    simt, pas = pm.simt_plan, ph.pas_plan

    def rec_simt(M, K, N, pool=1, *, whole=None):
        plan = simt(M, K, N, pool, whole=whole)
        rec.append(("simt", K, plan.splits))
        return plan

    def rec_pas(M, K, N, B, pool=1, *, whole=None):
        plan = pas(M, K, N, B, pool, whole=whole)
        rec.append(("pas", K, plan.splits))
        return plan

    pm.simt_plan, ph.pas_plan = rec_simt, rec_pas
    try:
        runs = {}
        for sharded in (False, True):
            rec.clear()
            for d in case["layers"]:
                conv = cv.Conv2D(**d["conv"])
                p = cv.ConvParams.shared(_t(d["idx"]), _t(d["codebook"]),
                                         bias=_t(d["bias"]))
                x = _t(d["x"])
                for eng in KERNEL_ENGINES:
                    cv.conv2d(x, p, conv, engine=eng,
                              mesh=mesh if sharded else None)
            runs[sharded] = list(rec)
    finally:
        pm.simt_plan, ph.pas_plan = simt, pas
    if runs[True] != runs[False]:
        raise AssertionError(f"split-K differs: sharded {runs[True]} vs "
                             f"single device {runs[False]}")
    return {"plans": runs[True]}


CHECKS = {
    "kinds": check_kinds,
    "nhwc_stride": check_nhwc_stride,
    "pool": check_pool,
    "uneven": check_uneven,
    "indivisible": check_indivisible,
    "refusals": check_refusals,
    "stack": check_stack,
    "matmul": check_matmul,
    "plans": check_plans,
}


def run(rank: int, world: int, shape: tuple, store: str, cases: str, out_dir: str):
    """One rank: every check on the ``shape`` mesh, results to ``out_dir``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        mesh = make_conv_mesh(shape, device="cpu")
        assert mesh.coords == (rank // shape[1], rank % shape[1])
        with open(cases, "rb") as f:
            data = pickle.load(f)
        results = {}
        for name, check in CHECKS.items():
            try:
                results[name] = ("ok", check(mesh, data.get(name)))
            except Exception:  # recorded: the parent reports it per check
                results[name] = ("fail", traceback.format_exc())
        with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    finally:
        dist.destroy_process_group()
