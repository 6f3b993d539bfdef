"""QAT and the PASM backwards of the port against the JAX package, on the CPU.

* ``core/qat.py``: the STE, the bin assignment and the codebook gradient.
* The K1/K2 autograd Functions (``kernels/ops.py``) against ``jax.grad`` of
  the JAX custom VJPs, Pallas in interpret mode, at the shapes
  ``tests/test_kernels.py``, ``test_conv_implicit.py`` and
  ``test_conv_pool.py`` use: shared, packed and grouped dictionaries, the
  fused ReLU, ``pool > 1`` and both conv engines.  On the CPU the
  Functions' forward is K1/K2's plain version.  Both sides get the same
  numpy operands and the same upstream gradient; the two sum the same f32
  products in another order, so ``|Δ| <= 1e-4·(1 + |jax|)``, the JAX
  suite's own backward tolerance.
* The CNN QAT stack (``models/cnn.py``) and one ``make_cnn_train_step``
  step from the same tree, as ``tests/test_cnn_qat.py`` holds the JAX side.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_lm import assert_update_close

from repro.configs import alexnet_conv as jcfg
from repro.core import conv as jcv
from repro.core import pasm as jp
from repro.core import qat as jqat
from repro.kernels import ops as jops
from repro.models import cnn as jcnn
from repro.train import optimizer as jopt
from repro.train import step as jstep
from repro_torch import interop
from repro_torch.configs import alexnet_conv as tcfg
from repro_torch.core import conv as tcv
from repro_torch.core import pasm as tp
from repro_torch.core import qat as tqat
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pasm_matmul as tpm
from repro_torch.models import cnn as tcnn
from repro_torch.train import optimizer as topt
from repro_torch.train import step as tstep

TOL = 1e-4


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.astype(np.float32), want, rtol=tol,
                               atol=tol * (1 + float(np.abs(want).max())), err_msg=what)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# core/qat.py
# ---------------------------------------------------------------------------


def test_ste_forward_and_grads_match_jax():
    rng = np.random.default_rng(0)
    cb = np.sort(rng.standard_normal(16)).astype(np.float32)
    w = rng.standard_normal((24, 5)).astype(np.float32)
    g = rng.standard_normal((24, 5)).astype(np.float32)
    yj = jqat.ste_quantize(jnp.asarray(w), jnp.asarray(cb))
    gwj, gcbj = jax.grad(lambda w_, c_: (jqat.ste_quantize(w_, c_) * g).sum(),
                         argnums=(0, 1))(jnp.asarray(w), jnp.asarray(cb))
    wt, cbt = _t(w, True), _t(cb, True)
    yt = tqat.ste_quantize(wt, cbt)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(yj))
    gwt, gcbt = torch.autograd.grad(yt, (wt, cbt), _t(g))
    np.testing.assert_array_equal(gwt.numpy(), np.asarray(gwj))  # straight through
    _close(gcbt, gcbj, what="codebook")
    np.testing.assert_array_equal(
        tqat.assign_bins(_t(w), _t(cb)).numpy(),
        np.asarray(jqat.assign_bins(jnp.asarray(w), jnp.asarray(cb))))
    _close(tqat.codebook_grads(_t(w), _t(cb), _t(g)),
           jqat.codebook_grads(jnp.asarray(w), jnp.asarray(cb), jnp.asarray(g)))


def test_ste_small_cases_as_jax_suite():
    """``tests/test_qat.py``'s hand cases: snapping, the identity gradient and
    the bin-summed codebook gradient."""
    cb = torch.tensor([-1.0, 0.0, 1.0])
    w = torch.tensor([-0.9, 0.1, 0.45, 2.0])
    assert tqat.ste_quantize(w, cb).tolist() == [-1.0, 0.0, 0.0, 1.0]
    w = torch.tensor([0.3, -0.6], requires_grad=True)
    (tqat.ste_quantize(w, cb) * torch.tensor([2.0, 3.0])).sum().backward()
    assert w.grad.tolist() == [2.0, 3.0]
    cb = torch.tensor([-1.0, 1.0], requires_grad=True)
    w = torch.tensor([-0.9, 0.8, 0.7, -0.2])
    up = torch.tensor([1.0, 2.0, 3.0, 4.0])
    (tqat.ste_quantize(w, cb) * up).sum().backward()
    assert cb.grad.tolist() == [5.0, 5.0]
    assert tqat.codebook_grads(w, cb, up).tolist() == [5.0, 5.0]


# ---------------------------------------------------------------------------
# K1: ops.pasm_matmul's backward vs jax.grad of _pasm_matmul / _pasm_matmul_ep
# ---------------------------------------------------------------------------


def _k1_operands(M, K, N, bins, groups, packed, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    tj = jp.quantize(jnp.asarray(w), bins=bins, groups=groups, pack=packed)
    tt = interop.pasm_tensor_from_numpy(
        dict(idx=np.asarray(tj.idx), codebook=np.asarray(tj.codebook), shape=tj.shape,
             bins=tj.bins, bits=tj.bits, packed=tj.packed), device="cpu")
    x = rng.standard_normal((M, K)).astype(np.float32)
    return rng, tj, tt, x


@pytest.mark.parametrize("M,K,N,bins,groups,packed,bias,relu,pool,dtype", [
    (6, 128, 48, 16, 4, True, False, False, 1, "float32"),   # the JAX gradcheck cases
    (6, 128, 48, 16, 2, True, False, False, 1, "float32"),
    (6, 128, 48, 64, 4, False, False, False, 1, "float32"),
    (6, 128, 48, 16, 1, True, False, False, 1, "float32"),
    (6, 128, 48, 16, 2, True, True, True, 1, "float32"),     # fused epilogue
    (5, 96, 17, 16, 2, False, True, False, 1, "float32"),    # ragged M/N
    (32, 48, 8, 8, 2, False, False, True, 2, "float32"),     # pooled, no bias
    (36, 364, 24, 16, 1, True, True, True, 3, "float32"),    # packed, pool 3
    (8, 64, 32, 16, 1, True, False, False, 1, "bfloat16"),   # the LM's bf16 x
])
def test_k1_backward_matches_jax(M, K, N, bins, groups, packed, bias, relu, pool, dtype):
    rng, tj, tt, x = _k1_operands(M, K, N, bins, groups, packed, M * K + N)
    b = np.linspace(-0.5, 0.5, N).astype(np.float32) if bias else None
    g = rng.standard_normal((M // (pool * pool), N)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def jloss(x_, cb_, b_):
        t_ = dataclasses.replace(tj, codebook=cb_)
        return (jops.pasm_matmul(x_, t_, bias=b_, relu=relu, pool=pool,
                                 interpret=True) * g).sum()

    args = (jnp.asarray(x).astype(jdt), tj.codebook,
            None if b is None else jnp.asarray(b))
    want = jax.jit(jax.grad(jloss, argnums=(0, 1) if b is None else (0, 1, 2)))(*args)
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    cbt = tt.codebook.clone().requires_grad_()
    bt = None if b is None else _t(b, True)
    y = tops.pasm_matmul(xt, dataclasses.replace(tt, codebook=cbt), bias=bt,
                         relu=relu, pool=pool)
    got = torch.autograd.grad(y, [xt, cbt] + ([] if bt is None else [bt]), _t(g))
    assert got[0].dtype == xt.dtype and got[1].shape == (groups, tt.codebook.shape[1])
    tol = 2.0 ** -7 if dtype == "bfloat16" else TOL  # dx rounds to bf16
    _close(got[0].float(), np.asarray(want[0], np.float32), tol, "dx")
    for a, w_, name in zip(got[1:], want[1:], ("codebook", "bias")):
        _close(a, w_, TOL, name)


def test_k1_packed_grouped_gradcheck_vs_dequant_chain():
    """The port's ``test_pasm_bwd_gradcheck_vs_dequant_chain``: the Function
    (packed int4, groups > 1) ≡ autograd through dequantize-then-dot."""
    _, _, tt, x = _k1_operands(6, 128, 48, 16, 4, True, 4)
    xt, cbt = _t(x, True), tt.codebook.clone().requires_grad_()
    lk = (tops.pasm_matmul(xt, dataclasses.replace(tt, codebook=cbt)) ** 2).sum()
    gk = torch.autograd.grad(lk, (xt, cbt))
    wd = tp.dequantize(dataclasses.replace(tt, codebook=cbt))
    gc = torch.autograd.grad(((xt @ wd) ** 2).sum(), (xt, cbt))
    for a, c in zip(gk, gc):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


def test_k1_kernel_wrapper_stays_forward_only():
    _, _, tt, x = _k1_operands(8, 64, 16, 16, 1, False, 1)
    with pytest.raises(RuntimeError, match="kernels.ops"):
        tpm.pasm_matmul_kernel_call(_t(x, True), tt.idx, tt.codebook, packed=False)
    # the op is differentiable; without grad it returns the same values
    y = tops.pasm_matmul(_t(x, True), tt)
    with torch.no_grad():
        assert torch.equal(y, tops.pasm_matmul(_t(x), tt))


def test_params_matmul_kernel_differentiable():
    """``params.matmul(impl="kernel")`` (packed, odd K: the §3 pad row)
    carries grads to x and the container's codebook, equal to
    ``impl="dequant"``'s up to the order of the f32 sums."""
    from repro_torch.core.params import PasmParams, matmul

    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((63, 20)).astype(np.float32))
    p = PasmParams.quantize(w, 16).pack()
    assert p.pad_k == 1
    x = torch.from_numpy(rng.standard_normal((5, 63)).astype(np.float32))
    grads = {}
    for impl in ("kernel", "dequant"):
        xt, cb = x.clone().requires_grad_(), p.codebook.clone().requires_grad_()
        y = matmul(xt, dataclasses.replace(p, codebook=cb), impl=impl)
        grads[impl] = torch.autograd.grad((y ** 2).sum(), (xt, cb))
    for a, c in zip(grads["kernel"], grads["dequant"]):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# conv2d(engine="kernel" | "kernel_implicit") backward vs JAX
# ---------------------------------------------------------------------------


def _conv_case(conv, bins, packed, hw, seed=0):
    rng = np.random.default_rng(seed)
    ih, iw = hw
    imgs = rng.standard_normal((2, conv.c_in, ih, iw)).astype(np.float32)
    kern = (rng.standard_normal((conv.c_out, conv.c_in, conv.ky, conv.kx))
            * conv.K ** -0.5).astype(np.float32)
    bias = np.linspace(-0.5, 0.5, conv.c_out).astype(np.float32)
    pj = jcv.ConvParams.quantize(jnp.asarray(kern), bins, bias=jnp.asarray(bias))
    if packed:
        pj = pj.pack()
    arr = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    pt = interop.conv_params_from_numpy(
        dict(kind=pj.kind, kshape=pj.kshape, bins=pj.bins, order=pj.order,
             pad_k=pj.pad_k, kernel=None, idx=arr(pj.idx),
             codebook=arr(pj.codebook), bias=arr(pj.bias)), device="cpu")
    return rng, imgs, pj, pt


@pytest.mark.parametrize("engine", ["kernel", "kernel_implicit"])
@pytest.mark.parametrize("k,c_in,stride,padding,relu,cbias,bins,packed,hw,pool", [
    (3, 5, 2, "same", True, True, 16, False, (13, 11), 1),   # epilogue VJP
    (3, 3, 1, "valid_centred", False, False, 8, True, (8, 8), 1),  # no epilogue, K pad
    (3, 5, 1, "same", True, True, 16, False, (13, 11), 2),   # fused pool, argmax
    (3, 3, 1, "valid_centred", False, False, 8, True, (9, 9), 2),  # pooled, packed
])
def test_conv_backward_matches_jax(engine, k, c_in, stride, padding, relu, cbias,
                                   bins, packed, hw, pool):
    jconv = jcv.Conv2D(k=k, c_in=c_in, c_out=8, stride=stride, padding=padding,
                       relu=relu, bias=cbias)
    tconv = tcv.Conv2D(k=k, c_in=c_in, c_out=8, stride=stride, padding=padding,
                       relu=relu, bias=cbias)
    rng, imgs, pj, pt = _conv_case(jconv, bins, packed, hw)
    yj = jax.eval_shape(lambda x_: jcv.conv2d(x_, pj, jconv, engine=engine,
                                              interpret=True, pool=pool), imgs)
    g = rng.standard_normal(yj.shape).astype(np.float32)

    def jloss(x_, cb_, b_):
        p_ = dataclasses.replace(pj, codebook=cb_, bias=b_)
        return (jcv.conv2d(x_, p_, jconv, engine=engine, interpret=True,
                           pool=pool) * g).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jnp.asarray(imgs), pj.codebook,
                                                     pj.bias)
    xt, cbt, bt = _t(imgs, True), pt.codebook.clone().requires_grad_(), \
        pt.bias.clone().requires_grad_()
    y = tcv.conv2d(xt, dataclasses.replace(pt, codebook=cbt, bias=bt), tconv,
                   engine=engine, pool=pool)
    assert tuple(y.shape) == tuple(yj.shape)
    names = ("x", "codebook", "bias")
    got = torch.autograd.grad(y, (xt, cbt, bt) if cbias else (xt, cbt), _t(g))
    for a, w_, name in zip(got, want, names):
        _close(a, w_, what=name)


# ---------------------------------------------------------------------------
# the CNN QAT stack
# ---------------------------------------------------------------------------


def _cnn_tree(params):
    arr = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    convs = [dict(kind=p.kind, kshape=p.kshape, bins=p.bins, order=p.order,
                  pad_k=p.pad_k, kernel=arr(p.kernel), idx=arr(p.idx),
                  codebook=arr(p.codebook), bias=arr(p.bias)) for p in params["conv"]]
    return {"conv": convs, "head": {k: arr(v) for k, v in params["head"].items()}}


@pytest.fixture(scope="module")
def smoke_qat():
    """The JAX package's smoke masters with the port's initial dictionaries,
    the same numpy tree on both sides."""
    cj, ct = jcfg.smoke_config(), tcfg.smoke_config()
    pj = jcnn.init_params(cj, jax.random.PRNGKey(0))
    params = interop.cnn_params_from_numpy(_cnn_tree(pj), device="cpu")
    cbs = tcnn.qat_codebooks(params, ct)
    cbj = [jnp.asarray(c.numpy()) for c in cbs]
    imgs = np.random.default_rng(1).standard_normal((2, *cj.in_chw)).astype(np.float32)
    return cj, ct, pj, cbj, imgs, {"params": params, "codebooks": cbs}


def test_qat_codebooks_and_groups_rule(smoke_qat):
    """One dictionary per layer, the one ``quantize`` serves; a grouped
    config is refused."""
    _, ct, _, _, _, tree = smoke_qat
    cbs = tree["codebooks"]
    assert len(cbs) == len(ct.layers)
    for cb, q in zip(cbs, tcnn.quantize(tree["params"], ct)["conv"]):
        assert cb.shape == (ct.bins,)
        assert torch.equal(cb, q.codebook)
    gcfg = dataclasses.replace(ct, groups=2)
    with pytest.raises(ValueError, match="single-dictionary"):
        tcnn.qat_codebooks(tree["params"], gcfg)
    with pytest.raises(ValueError, match="single-dictionary"):
        tcnn.qat_requantize(tree["params"], cbs, gcfg)


@pytest.mark.parametrize("packed", [False, True])
def test_qat_forward_and_requantize_match_jax(smoke_qat, packed):
    cj, ct, pj, cbj, imgs, tree = smoke_qat
    cj, ct = (dataclasses.replace(c, packed=packed) for c in (cj, ct))
    params, cbs = tree["params"], tree["codebooks"]
    got = tcnn.qat_forward(params, cbs, _t(imgs), ct)
    want = jax.jit(lambda p_, c_, x_: jcnn.qat_forward(p_, c_, x_, cj))(
        pj, cbj, jnp.asarray(imgs))
    _close(got, want, 1e-3)
    # qat_forward == forward_dense at the snapped masters, bitwise
    assert torch.equal(got, tcnn.forward_dense(tcnn.qat_apply(params, cbs), _t(imgs), ct))
    qt = tcnn.qat_requantize(params, cbs, ct)
    qj = jcnn.qat_requantize(pj, cbj, cj)
    for a, b in zip(qt["conv"], qj["conv"]):
        assert a.kind == b.kind == ("packed" if packed else "shared")
        np.testing.assert_array_equal(a.idx.numpy(), np.asarray(b.idx))
    for impl in ("einsum", "kernel", "kernel_implicit"):
        served = tcnn.forward(qt, _t(imgs), dataclasses.replace(ct, impl=impl))
        torch.testing.assert_close(served, got, rtol=1e-4, atol=1e-4)


def test_qat_gradcheck_ste_identity_and_codebook_bins(smoke_qat):
    """Masters get the straight-through gradient — that of the dense
    forward at the snapped weights — and each codebook entry the bin sum of
    its weights' gradients."""
    _, ct, _, _, imgs, tree = smoke_qat
    params = tree["params"]
    ks = [p.kernel.clone().requires_grad_() for p in params["conv"]]
    cbs = [c.clone().requires_grad_() for c in tree["codebooks"]]

    def with_kernels(kk):
        convs = [tcv.ConvParams.dense(k, bias=p.bias) for k, p in zip(kk, params["conv"])]
        return {"conv": convs, "head": params["head"]}

    loss = (tcnn.qat_forward(with_kernels(ks), cbs, _t(imgs), ct) ** 2).mean()
    g = torch.autograd.grad(loss, ks + cbs)
    g_k, g_cb = g[: len(ks)], g[len(ks):]
    snapped = [tqat.ste_quantize(k, c).detach().requires_grad_() for k, c in zip(ks, cbs)]
    g_dense = torch.autograd.grad(
        (tcnn.forward_dense(with_kernels(snapped), _t(imgs), ct) ** 2).mean(), snapped)
    for a, b in zip(g_k, g_dense):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    for k, c, gk, gc in zip(ks, cbs, g_dense, g_cb):
        torch.testing.assert_close(gc, tqat.codebook_grads(k.detach(), c.detach(), gk),
                                   rtol=1e-5, atol=1e-6)


def test_cnn_train_step_matches_jax(smoke_qat):
    """One ``make_cnn_train_step`` step from the same tree, optimizer state
    and batch: loss, skipped flag and every updated leaf."""
    cj, ct, pj, cbj, imgs, tree = smoke_qat
    ocfg_j = jopt.AdamWConfig(lr=1e-2, warmup_steps=1)
    ocfg_t = topt.AdamWConfig(lr=1e-2, warmup_steps=1)
    labels = np.array([1, 3], np.int32)
    jtree = {"params": pj, "codebooks": cbj}
    nj, sj, mj = jax.jit(jstep.make_cnn_train_step(cj, ocfg_j))(
        jtree, jopt.init_opt_state(jtree),
        {"images": jnp.asarray(imgs), "labels": jnp.asarray(labels)})
    nt, st, mt = tstep.make_cnn_train_step(ct, ocfg_t)(
        tree, topt.init_opt_state(tree),
        {"images": _t(imgs), "labels": torch.from_numpy(labels)})
    assert int(mt["skipped"]) == int(mj["skipped"]) == 0 and int(st.step) == 1
    _close(mt["loss"], mj["loss"], 1e-5, "loss")
    _close(mt["grad_norm"], mj["grad_norm"], 1e-4, "grad_norm")
    assert_update_close((nt, st), (nj, sj), 1e-4, g_floor=1e-3)
