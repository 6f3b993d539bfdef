"""deepseek-moe-16b: fine-grained MoE, 2 shared + 64 routed top-6.  [arXiv:2401.06066]"""
from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b",
        family="moe",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=10_944,  # the single leading dense layer's FFN (published width)
        vocab=102_400,
        act="swiglu",
        rope_theta=10_000.0,
        moe=MoEConfig(
            n_experts=64,
            top_k=6,
            d_expert=1408,  # assignment d_ff applies per expert
            n_shared=2,
            d_shared=1408,
            capacity_factor=1.25,
            first_dense_layers=1,
        ),
        source="arXiv:2401.06066",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="swiglu",
        moe=MoEConfig(
            n_experts=8,
            top_k=2,
            d_expert=32,
            n_shared=2,
            d_shared=32,
            capacity_factor=1.5,
            first_dense_layers=1,
        ),
        remat=False,
    )
