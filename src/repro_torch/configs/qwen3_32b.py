"""qwen3-32b: dense, qk_norm, GQA kv=8.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=25_600,
        vocab=151_936,
        act="swiglu",
        qk_norm=True,
        rope_theta=1_000_000.0,
        source="hf:Qwen/Qwen3-8B (scaled per assignment)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-32b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="swiglu",
        qk_norm=True,
        remat=False,
    )
