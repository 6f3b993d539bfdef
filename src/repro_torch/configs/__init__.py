"""Model configurations: the LM architecture registry and the AlexNet CNN.

Port of ``repro.configs``.  :func:`get_config` resolves ``--arch <id>`` for
every entry point.  The registry names all ten archs of the JAX package,
every family ported: the transformer families (dense, MoE and the
vit-prefixed VLM), the SSM family, the RG-LRU hybrid and the audio
encoder-decoder.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ArchConfig, PASMQuant, ShapeSpec  # noqa: F401

__all__ = ["ARCH_IDS", "CNN_IDS", "get_config", "get_shape", "get_cnn_config",
           "cell_supported", "all_cells"]

_MODULES = {
    "qwen3-32b": "qwen3_32b",
    "nemotron-4-340b": "nemotron4_340b",
    "phi3-medium-14b": "phi3_medium_14b",
    "stablelm-3b": "stablelm_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-130m": "mamba2_130m",
    "whisper-tiny": "whisper_tiny",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str, *, smoke: bool = False) -> ArchConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke_config() if smoke else mod.config()


def get_shape(name: str) -> ShapeSpec:
    return SHAPES[name]


# CNN (vision) registry — separate from the LM cells above: CNNConfig is not
# an ArchConfig and the conv stack has no prefill/decode surface.
CNN_IDS = ("alexnet",)


def get_cnn_config(name: str, *, smoke: bool = False):
    if name not in CNN_IDS:
        raise KeyError(f"unknown cnn {name!r}; known: {CNN_IDS}")
    from repro_torch.configs import alexnet_conv as mod

    return mod.smoke_config() if smoke else mod.config()


# cells skipped by design (sub-quadratic requirement / no decoder):
# full-attention archs skip long_500k.
_SUBQUADRATIC = {"mamba2-130m", "recurrentgemma-2b"}


def cell_supported(arch: str, shape: str) -> tuple[bool, str]:
    if shape == "long_500k" and arch not in _SUBQUADRATIC:
        return False, "full-attention arch: O(s²) at 524k ctx — skipped by design"
    return True, ""


def all_cells():
    """The 40 (arch × shape) cells, with supported flag + reason."""
    out = []
    for a in ARCH_IDS:
        for s in SHAPES:
            ok, why = cell_supported(a, s)
            out.append((a, s, ok, why))
    return out
