"""The AlexNet-style stack in plain PyTorch, f32 with TF32 off.

Follows the configuration file: conv stages of ``(c_out, k, stride)`` with
bias and ReLU, a non-overlapping ``pool × pool`` max pool (floor windowing)
where ``pool > 1``, then one dense head over the flattened ``(C, H, W)``
features.  ``valid_centred`` windows start at the image's corner; for an odd
kernel they are VALID's, for an even one they stop one output short.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from portbench.reference import draw

__all__ = ["out_hw", "weights", "forward"]


def out_hw(size: int, k: int, stride: int, padding: str) -> int:
    if padding == "valid":
        return (size - k) // stride + 1
    if padding != "valid_centred":
        raise ValueError(f"padding {padding!r} is not modelled by the reference")
    return (size - 2 * (k // 2) + stride - 1) // stride


def weights(cfg: dict, seed: int, device) -> dict:
    """The stack's dense f32 weights, drawn again from the seed."""
    convs, c_in = [], cfg["in_chw"][0]
    for i, (c_out, k, _stride) in enumerate(cfg["layers"]):
        idx, cb, b = draw.cnn_conv(seed, i, c_out, c_in, k, cfg["bins"], device)
        convs.append((draw.dense_matrix(idx, cb), b))
        c_in = c_out
    w, b = draw.cnn_head(seed, cfg["features"], cfg["classes"], device)
    return {"conv": convs, "head": (w, b)}


def forward(cfg: dict, w: dict, images: torch.Tensor,
            rnd: Optional[Callable] = None) -> torch.Tensor:
    """``images (B, C, H, W)`` f32 → logits ``(B, classes)`` f32.  ``rnd``
    rounds both operands of every product (a control's precision)."""
    r = rnd or (lambda t: t)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        x = images.float()
        for (kern, b), (_c, k, stride), pool in zip(w["conv"], cfg["layers"], cfg["pools"]):
            oh = out_hw(x.shape[2], k, stride, cfg["padding"])
            ow = out_hw(x.shape[3], k, stride, cfg["padding"])
            x = F.conv2d(r(x), r(kern), b, stride=stride)[:, :, :oh, :ow]
            x = torch.relu(x)
            if pool > 1:
                x = F.max_pool2d(x, pool)
        hw, hb = w["head"]
        return r(x.reshape(x.shape[0], -1)) @ r(hw) + hb
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
