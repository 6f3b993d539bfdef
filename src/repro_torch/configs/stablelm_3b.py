"""stablelm-3b: dense, MHA (kv=32=H).  [hf:stabilityai/stablelm-2-1_6b family]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b",
        family="dense",
        n_layers=32,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab=50_304,
        act="swiglu",
        rope_theta=10_000.0,
        source="hf:stabilityai/stablelm-2-1_6b (scaled per assignment)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="stablelm-3b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="swiglu",
        remat=False,
    )
