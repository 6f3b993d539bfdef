"""The dense decoder-only transformer in plain PyTorch, f32 with TF32 off.

The layer of the configuration file (phi3-medium's, arXiv:2404.14219): RMS
norm before attention and before the FFN, grouped-query attention over
``n_kv_heads`` with rotary positions (the half-split rotation, θ =
``rope_theta``) and a causal mask over the whole prefix, a SwiGLU FFN
``w2(silu(w1 x) · w3 x)``, a final RMS norm and an untied head.  The QKV and
gate-up projections are separate matrices here; phi3's fused ones are the
same products side by side.

It runs a batch of whole sequences layer by layer, each layer's weights
drawn again from the seed (:mod:`portbench.reference.draw`), so it holds one
layer's f32 weights at a time, and returns the logits at the positions asked
for.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.reference import draw

__all__ = ["logits_at"]


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _tables(T: int, hd: int, theta: float, device) -> tuple:
    half = hd // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float64, device=device) / half)
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * freqs
    return torch.cos(ang).float(), torch.sin(ang).float()


def _layer(h: torch.Tensor, W: dict, cfg: dict, mm: Callable, tables: tuple) -> torch.Tensor:
    T = h.shape[0]
    H, KV, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    G = H // KV
    x = _rms_norm(h, W["attn_norm"], cfg["norm_eps"])
    cos, sin = tables[0][:T], tables[1][:T]
    q = _rope(mm(x, W["wq"]).view(T, H, hd), cos, sin)
    k = _rope(mm(x, W["wk"]).view(T, KV, hd), cos, sin)
    v = mm(x, W["wv"]).view(T, KV, hd)
    qg = q.view(T, KV, G, hd).permute(1, 2, 0, 3)  # (KV, G, T, hd)
    s = mm(qg, k.permute(1, 2, 0)[:, None]) * hd ** -0.5  # (KV, G, T, T)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(p, v.permute(1, 0, 2)[:, None])  # (KV, G, T, hd)
    h = h + mm(o.permute(2, 0, 1, 3).reshape(T, H * hd), W["wo"])
    x = _rms_norm(h, W["ffn_norm"], cfg["norm_eps"])
    return h + mm(F.silu(mm(x, W["w1"])) * mm(x, W["w3"]), W["w2"])


def logits_at(cfg: dict, seed: int, seqs: Sequence[torch.Tensor],
              positions: Sequence[torch.Tensor], device,
              rnd: Optional[Callable] = None) -> list:
    """The f32 logits ``(len(pos), V)`` of each token sequence at its
    ``positions`` (the logits that predict the token after each).  ``rnd``
    rounds both operands of every product (a control's precision)."""
    r = rnd or (lambda t: t)

    def mm(a, b):
        return torch.matmul(r(a), r(b))

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        embed = draw.lm_embed(seed, cfg, device)
        hs = [embed[s.to(device).long()].float() for s in seqs]
        del embed
        tables = _tables(max(int(s.numel()) for s in seqs), cfg["head_dim"],
                         cfg["rope_theta"], device)
        for layer in range(cfg["n_layers"]):
            W = draw.lm_layer(seed, layer, cfg, device)
            W = {k: draw.dense_matrix(*v) if isinstance(v, tuple) else v for k, v in W.items()}
            hs = [_layer(h, W, cfg, mm, tables) for h in hs]
            del W
        head = draw.dense_matrix(*draw.lm_head(seed, cfg, device))
        fnorm = draw.lm_norm(seed, "final_norm", cfg["d_model"], device)
        return [mm(_rms_norm(h[p.to(device).long()], fnorm, cfg["norm_eps"]), head)
                for h, p in zip(hs, positions)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
