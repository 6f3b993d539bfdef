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
  "b"}}`` → the params dict :func:`repro_torch.models.cnn.forward` takes.

Arrays keep their dtype (uint8 indices, float32 values) and are placed on
``device`` (default the card).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.conv import ConvParams
from repro_torch.core.pasm import PASMTensor

__all__ = ["pasm_tensor_from_numpy", "conv_params_from_numpy",
           "cnn_params_from_numpy"]


def _t(a: Optional[np.ndarray], dev: torch.device) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.from_numpy(np.array(a, order="C")).to(dev)  # a writable copy


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
