"""Shared by the LM parity tests: carry a JAX params tree into the port."""
import numpy as np

from repro.core.params import PasmParams
from repro_torch.interop import lm_params_from_numpy

_FIELDS = ("w", "idx", "codebook", "bias")


def tree_to_numpy(t):
    """The JAX transformer's params tree as numpy: dense leaves as arrays,
    ``PasmParams`` leaves as field dicts (leading layer axis kept)."""
    if isinstance(t, PasmParams):
        d = {f: None if getattr(t, f) is None else np.asarray(getattr(t, f))
             for f in _FIELDS}
        return {"kind": t.kind, "shape": t.shape, "bins": t.bins,
                "pad_k": t.pad_k, **d}
    if isinstance(t, dict):
        return {k: tree_to_numpy(v) for k, v in t.items()}
    return np.asarray(t)


def port_params(jax_params):
    return lm_params_from_numpy(tree_to_numpy(jax_params), device="cpu")
