"""internvl2-26b: VLM — InternViT frontend (stub) + InternLM2 backbone.  [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=16_384,
        vocab=92_553,
        act="swiglu",
        rope_theta=1_000_000.0,
        frontend="vit",
        frontend_tokens=256,  # pixel-shuffled InternViT patches per image
        frontend_dim=3200,  # InternViT-6B hidden size (stub embeddings)
        source="arXiv:2404.16821",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="swiglu",
        frontend="vit",
        frontend_tokens=8,
        frontend_dim=48,
        remat=False,
    )
