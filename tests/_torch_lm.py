"""Shared by the LM parity tests: carry a JAX params tree into the port."""
import contextlib

import numpy as np

from repro.core.conv import ConvParams
from repro.core.params import PasmParams
from repro_torch.interop import lm_params_from_numpy

_FIELDS = ("w", "idx", "codebook", "bias")
_CONV_FIELDS = ("kernel", "idx", "codebook", "bias")


def tree_to_numpy(t):
    """The JAX LM params tree as numpy: dense leaves as arrays,
    ``PasmParams`` leaves as field dicts (leading layer axis kept),
    ``ConvParams`` (the encdec mel stem) as field dicts with their
    ``kshape``, lists (the MoE family's ``dense_layers``) as lists."""
    if isinstance(t, ConvParams):
        d = {f: None if getattr(t, f) is None else np.asarray(getattr(t, f))
             for f in _CONV_FIELDS}
        return {"kind": t.kind, "kshape": t.kshape, "bins": t.bins,
                "order": t.order, "pad_k": t.pad_k, **d}
    if isinstance(t, PasmParams):
        d = {f: None if getattr(t, f) is None else np.asarray(getattr(t, f))
             for f in _FIELDS}
        return {"kind": t.kind, "shape": t.shape, "bins": t.bins,
                "pad_k": t.pad_k, **d}
    if isinstance(t, dict):
        return {k: tree_to_numpy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [tree_to_numpy(v) for v in t]
    return np.asarray(t)


def port_params(jax_params):
    return lm_params_from_numpy(tree_to_numpy(jax_params), device="cpu")


def _key(p):
    for a in ("key", "name", "idx"):
        if hasattr(p, a):
            return str(getattr(p, a))
    return str(p)


def jax_flat(tree):
    """A JAX tree as ``{"a/b/c": numpy}`` keyed by its pytree paths."""
    import jax

    return {"/".join(_key(p) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# the port's per-layer (per-group) lists that JAX stacks on a leading axis
_STACKED = ("layers", "groups", "enc_layers", "dec_layers")


def port_flat(tree):
    """A port tree keyed as :func:`jax_flat` keys the JAX one: the
    per-layer (``"layers"``, ``"enc_layers"``, ``"dec_layers"``) and
    per-group (``"groups"``) lists are stacked on a leading axis."""
    import torch

    from repro_torch.tree import flatten_with_path

    out, stacked = {}, set()
    for path, leaf in flatten_with_path(tree):
        key = next((k for k in _STACKED if k in path), None)
        if key is not None:
            i = path.index(key)
            path = path[: i + 1] + path[i + 2:]
            stacked.add("/".join(path))
        a = leaf.detach().cpu()
        out.setdefault("/".join(path), []).append(
            (a.float() if a.dtype == torch.bfloat16 else a).numpy())
    return {k: np.stack(v) if k in stacked else v[0] for k, v in out.items()}


def assert_update_close(port_state, jax_state, tol, *, g_floor, p_tol=1e-5):
    """One optimizer step of both packages from the same state: the moments
    (linear in the gradient) everywhere within ``tol`` of the largest; the
    new params within ``p_tol`` where ``|mu| >= g_floor·max|mu|`` of the
    leaf.  The first AdamW step moves a weight by ``lr·g/(|g| + eps)``,
    which does not depend on ``g``'s last digits unless ``g`` is within
    their reach of zero: ``g_floor`` must exceed the moments' tolerance."""
    pp, ps = port_state
    jpp, js = jax_state
    got, want = port_flat({"p": pp, "mu": ps.mu, "nu": ps.nu}), \
        jax_flat({"p": jpp, "mu": js.mu, "nu": js.nu})
    assert int(ps.step) == int(js.step)
    for k, w in want.items():
        if k.endswith("/idx"):
            continue
        g = got[k]
        assert g.shape == w.shape, k
        w = w.astype(np.float32)
        if k.startswith("p/"):
            mu = np.abs(want["mu/" + k[2:]])
            mask = mu >= g_floor * mu.max()
            np.testing.assert_allclose(g[mask], w[mask], rtol=p_tol, atol=p_tol,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=tol * float(np.abs(w).max(initial=0)),
                                       err_msg=k)


@contextlib.contextmanager
def f32_activations(jax_model, port_model):
    """Run both packages' model module with f32 activations where they
    cast to bf16 (the JAX module's ``jnp.bfloat16``, the port's ``_ACT``):
    the same algorithm without bf16 rounding, to be held to f32 noise.
    Pass the caches in f32 too.  JAX functions must be traced inside."""
    import jax.numpy as jnp
    import torch

    class _F32:
        bfloat16 = jnp.float32

        def __getattr__(self, name):
            return getattr(jnp, name)

    jnp_, act = jax_model.jnp, port_model._ACT
    jax_model.jnp, port_model._ACT = _F32(), torch.float32
    try:
        yield
    finally:
        jax_model.jnp, port_model._ACT = jnp_, act
