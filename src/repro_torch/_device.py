"""The port's device rule: entry points run on the card unless asked not to."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device raises when no card is
    present — there is no silent CPU fallback (pass ``device="cpu"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' for the plain CPU path"
        )
    return dev
