"""Carry the JAX package's weights across as numpy arrays.

The port never imports the JAX package; a caller that has both (the parity
tests) flattens ``repro``'s dataclasses into plain numpy trees and hands
them here:

* :func:`pasm_tensor_from_numpy` — ``{"idx", "codebook", "shape", "bins",
  "bits", "packed"}`` → :class:`~repro_torch.core.pasm.PASMTensor`;
* :func:`conv_params_from_numpy` — ``{"kind", "kshape", "bins", "order",
  "pad_k", "kernel", "idx", "codebook", "bias"}`` (absent arrays None) →
  :class:`~repro_torch.core.conv.ConvParams`;
* :func:`cnn_params_from_numpy` — ``{"conv": [conv dicts], "head": {"w",
  "b"}}`` → the params dict :func:`repro_torch.models.cnn.forward` takes;
* :func:`lm_params_from_numpy` — the JAX transformer's params tree (from
  ``init_params``, optionally ``quantize_params``) with every dense leaf an
  array and every ``PasmParams`` leaf a ``{"kind", "shape", "bins",
  "pad_k", "w", "idx", "codebook", "bias"}`` dict, per-layer leaves keeping
  their leading layer axis → the port's tree, whose ``"layers"`` is a list
  of per-layer dicts and whose ``"groups"`` (the hybrid's scanned (R, R,
  A) groups) a list of per-group dicts.  The MoE family's
  ``"dense_layers"`` and the hybrid's ``"tail"`` are already lists of
  per-layer dicts (as in JAX) and stay lists; a stacked expert leaf
  ``(L, E, K, N)`` becomes, per layer, a ``PasmParams`` (or array) with a
  leading E, each expert's dictionaries its own.  The encdec family's
  ``"enc_layers"`` and ``"dec_layers"`` stacks become per-layer lists
  too, and its mel stem's ``ConvParams`` (a field dict with a ``"kshape"``,
  from ``quantize_frontend``) goes through :func:`conv_params_from_numpy`;
  an unquantized stem stays a plain ``{"kernel", "bias"}`` dict;
* :func:`cnn_qat_tree_from_numpy` — the CNN QAT tree ``{"params": cnn
  tree, "codebooks": [(bins,) arrays]}`` → the tree
  :func:`repro_torch.train.step.make_cnn_train_step` trains;
* :func:`opt_state_from_numpy` — ``{"step", "mu", "nu"}`` (the JAX
  ``OptState``, its moment trees in the format of the params tree they
  mirror, 0-d placeholders at integer leaves) →
  :class:`~repro_torch.train.optimizer.OptState`, each moment tree through
  the converter of its params tree.

Arrays keep their dtype (uint8 indices, float32 or bfloat16 values; a
bfloat16 array, ``ml_dtypes.bfloat16`` as JAX hands it to numpy, crosses
bitwise through an ``int16`` view) and are placed on ``device`` (default
the card).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.conv import ConvParams
from repro_torch.core.params import PasmParams
from repro_torch.core.pasm import PASMTensor
from repro_torch.train.optimizer import OptState
from repro_torch.tree import STACKED

__all__ = ["pasm_tensor_from_numpy", "conv_params_from_numpy",
           "cnn_params_from_numpy", "lm_params_from_numpy",
           "cnn_qat_tree_from_numpy", "opt_state_from_numpy"]


def _t(a: Optional[np.ndarray], dev: torch.device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    a = np.array(a, order="C")  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carried bitwise
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def pasm_tensor_from_numpy(d: dict, *, device=None) -> PASMTensor:
    dev = resolve_device(device)
    return PASMTensor(idx=_t(d["idx"], dev), codebook=_t(d["codebook"], dev),
                      shape=tuple(int(s) for s in d["shape"]),
                      bins=int(d["bins"]), bits=int(d["bits"]),
                      packed=bool(d["packed"]))


def conv_params_from_numpy(d: dict, *, device=None) -> ConvParams:
    dev = resolve_device(device)
    if d["kind"] not in ("dense", "shared", "packed"):
        raise ValueError(f"unknown ConvParams kind {d['kind']!r}")
    return ConvParams(
        kernel=_t(d.get("kernel"), dev), idx=_t(d.get("idx"), dev),
        codebook=_t(d.get("codebook"), dev), bias=_t(d.get("bias"), dev),
        kind=d["kind"], kshape=tuple(int(s) for s in d["kshape"]),
        bins=None if d.get("bins") is None else int(d["bins"]),
        order=d.get("order"), pad_k=int(d.get("pad_k", 0)),
    )


def cnn_params_from_numpy(tree: dict, *, device=None) -> dict:
    dev = resolve_device(device)
    return {
        "conv": [conv_params_from_numpy(c, device=dev) for c in tree["conv"]],
        "head": {"w": _t(tree["head"]["w"], dev), "b": _t(tree["head"]["b"], dev)},
    }


_PASM_FIELDS = ("w", "idx", "codebook", "bias")


def _lm_leaf(x, dev: torch.device, layer: Optional[int]):
    """One leaf: an array, or a ``PasmParams`` field dict; ``layer`` picks one
    slice of the leading layer axis."""
    def pick(a):  # a 0-d array is an optimizer moment's placeholder: shared
        return a if layer is None or a is None or np.ndim(a) == 0 else a[layer]

    if isinstance(x, dict) and "kshape" in x:  # a ConvParams: the mel stem
        return conv_params_from_numpy(x, device=dev)
    if isinstance(x, dict) and "kind" in x:
        arrays = {f: _t(pick(x.get(f)), dev) for f in _PASM_FIELDS}
        return PasmParams(**arrays, kind=x["kind"],
                          shape=tuple(int(s) for s in x["shape"]),
                          bins=None if x.get("bins") is None else int(x["bins"]),
                          pad_k=int(x.get("pad_k", 0)))
    if isinstance(x, dict):
        return {k: _lm_leaf(v, dev, layer) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_lm_leaf(v, dev, layer) for v in x]
    return _t(pick(x), dev)


def _n_layers(tree) -> int:
    if isinstance(tree, dict) and "kind" in tree:
        return next(int(np.shape(tree[f])[0]) for f in _PASM_FIELDS
                    if tree.get(f) is not None and np.ndim(tree[f]))
    if isinstance(tree, dict):
        return _n_layers(next(iter(tree.values())))
    return int(np.shape(tree)[0])


def lm_params_from_numpy(tree: dict, *, device=None) -> dict:
    dev = resolve_device(device)
    out = {}
    for k, v in tree.items():
        if k in STACKED:
            out[k] = [_lm_leaf(v, dev, i) for i in range(_n_layers(v))]
        else:
            out[k] = _lm_leaf(v, dev, None)
    return out


def cnn_qat_tree_from_numpy(tree: dict, *, device=None) -> dict:
    dev = resolve_device(device)
    return {"params": cnn_params_from_numpy(tree["params"], device=dev),
            "codebooks": [_t(c, dev) for c in tree["codebooks"]]}


def opt_state_from_numpy(d: dict, tree_from_numpy, *, device=None):
    """``tree_from_numpy`` is the params tree's converter, e.g.
    :func:`lm_params_from_numpy` or :func:`cnn_qat_tree_from_numpy`."""
    dev = resolve_device(device)
    return OptState(step=_t(np.asarray(d["step"], np.int32), dev),
                    mu=tree_from_numpy(d["mu"], device=dev),
                    nu=tree_from_numpy(d["nu"], device=dev))
