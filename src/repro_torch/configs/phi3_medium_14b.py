"""phi3-medium-14b: dense, RoPE SwiGLU GQA kv=10.  [arXiv:2404.14219]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=40,
        n_kv_heads=10,
        head_dim=128,
        d_ff=17_920,
        vocab=100_352,
        act="swiglu",
        rope_theta=10_000.0,
        source="arXiv:2404.14219",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="phi3-medium-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=80,
        n_heads=5,
        n_kv_heads=5,
        head_dim=16,
        d_ff=160,
        vocab=256,
        act="swiglu",
        remat=False,
    )
