"""The benchmark's weights and inputs, drawn from the run's seed.

Plain PyTorch and NumPy.  Both sides take what is drawn here: the harness
hands it to the program in the program's own containers, and the reference
draws it again, leaf by leaf, from the same seed, so it takes nothing the
program holds.  Every leaf has its own generator, seeded from the run's seed
and the leaf's name, so a leaf can be drawn alone and in any order.

A weight-shared matrix is its logical ``(K, N)`` bin indices, uniform over
the bins, and one dictionary of ``bins`` values: normals standardized to
mean 0 and variance 1 (so no layer is biased to one sign), sorted, times
``gain · fan_in ** -0.5``, so a layer keeps the variance of its input
(``gain`` √2 before a ReLU).
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

__all__ = ["sub_seed", "generator", "shared", "dense_matrix", "normal",
           "cnn_conv", "cnn_head", "images", "lm_layer", "lm_embed", "lm_norm",
           "lm_head", "LM_MATRICES"]


def sub_seed(seed: int, key: str) -> int:
    """A 63-bit seed for leaf ``key`` of run ``seed`` (any whole number)."""
    h = hashlib.sha256(f"{int(seed)}/{key}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, key: str, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(sub_seed(seed, key))
    return g


def shared(seed: int, key: str, shape: tuple, bins: int, fan_in: int, device,
           gain: float = 1.0) -> tuple:
    """``(idx uint8 of shape, codebook (bins,) f32)`` of one weight-shared leaf."""
    g = generator(seed, key, device)
    idx = torch.randint(0, bins, shape, generator=g, device=device, dtype=torch.uint8)
    v = torch.randn(bins, generator=g, device=device)
    v = (v - v.mean()) / v.std()
    return idx, torch.sort(v).values * (gain * fan_in ** -0.5)


def dense_matrix(idx: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The f32 weight a leaf stands for: each index looked up in its dictionary."""
    return codebook[idx.long()]


def normal(seed: int, key: str, shape: tuple, std: float, device, dtype=torch.float32):
    g = generator(seed, key, device)
    return (torch.randn(shape, generator=g, device=device) * std).to(dtype)


# ---------------------------------------------------------------------------
# the CNN
# ---------------------------------------------------------------------------


def cnn_conv(seed: int, i: int, c_out: int, c_in: int, k: int, bins: int, device) -> tuple:
    """Conv stage ``i``: ``(idx (c_out, c_in, k, k) uint8, codebook (bins,), bias (c_out,))``."""
    idx, cb = shared(seed, f"conv{i}", (c_out, c_in, k, k), bins, c_in * k * k, device,
                     gain=2.0 ** 0.5)
    return idx, cb, normal(seed, f"conv{i}.bias", (c_out,), 0.01, device)


def cnn_head(seed: int, features: int, classes: int, device) -> tuple:
    """The dense head: ``(w (features, classes) f32, b (classes,))``."""
    return (normal(seed, "head.w", (features, classes), features ** -0.5, device),
            normal(seed, "head.b", (classes,), 0.01, device))


def images(seed: int, n: int, chw: tuple) -> np.ndarray:
    """``n`` standard-normal f32 images ``(n, C, H, W)`` on the host."""
    rng = np.random.Generator(np.random.PCG64(sub_seed(seed, "images")))
    return rng.standard_normal((n,) + tuple(chw), dtype=np.float32)


# ---------------------------------------------------------------------------
# the dense transformer LM
# ---------------------------------------------------------------------------

# each layer's weight-shared matrices: name -> (K, N) from the config's sizes
LM_MATRICES = ("wq", "wk", "wv", "wo", "w1", "w3", "w2")


def _lm_shape(cfg: dict, name: str) -> tuple:
    D, F = cfg["d_model"], cfg["d_ff"]
    q, kv = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    return {"wq": (D, q), "wk": (D, kv), "wv": (D, kv), "wo": (q, D),
            "w1": (D, F), "w3": (D, F), "w2": (F, D)}[name]


def lm_layer(seed: int, layer: int, cfg: dict, device) -> dict:
    """Layer ``layer``'s leaves: each matrix's ``(idx, codebook)`` and the two
    norm weights (``attn_norm``, ``ffn_norm``, f32, about 1)."""
    out = {}
    for name in LM_MATRICES:
        K, N = _lm_shape(cfg, name)
        out[name] = shared(seed, f"layer{layer}.{name}", (K, N), cfg["bins"], K, device)
    for name in ("attn_norm", "ffn_norm"):
        out[name] = lm_norm(seed, f"layer{layer}.{name}", cfg["d_model"], device)
    return out


def lm_norm(seed: int, key: str, d: int, device) -> torch.Tensor:
    """An RMS norm's weight: ``1 + N(0, 0.1²)``, f32."""
    return 1.0 + normal(seed, key, (d,), 0.1, device)


def lm_embed(seed: int, cfg: dict, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The ``(V, D)`` embedding table, N(0, 0.02²), in the type it is held in
    (bf16 to serve, f32 to train)."""
    return normal(seed, "embed", (cfg["vocab"], cfg["d_model"]), 0.02, device, dtype)


def lm_head(seed: int, cfg: dict, device) -> tuple:
    """The weight-shared ``(D, V)`` head: ``(idx, codebook)``."""
    D = cfg["d_model"]
    return shared(seed, "lm_head", (D, cfg["vocab"]), cfg["bins"], D, device)
