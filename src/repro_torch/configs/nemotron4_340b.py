"""nemotron-4-340b: dense, GQA kv=8, squared-ReLU.  [arXiv:2402.16819]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b",
        family="dense",
        n_layers=96,
        d_model=18_432,
        n_heads=96,
        n_kv_heads=8,
        head_dim=192,
        d_ff=73_728,
        vocab=256_000,
        act="sq_relu",
        rope_theta=10_000.0,
        source="arXiv:2402.16819",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-340b-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        n_heads=6,
        n_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab=256,
        act="sq_relu",
        remat=False,
    )
