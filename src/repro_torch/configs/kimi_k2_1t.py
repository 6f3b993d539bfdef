"""kimi-k2-1t-a32b: trillion-param MoE, 384 experts top-8.  [arXiv:2501.kimi2, paper-table]"""
from repro_torch.configs.base import ArchConfig, MoEConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=18_432,  # the single leading dense layer's FFN (published width)
        vocab=163_840,
        act="swiglu",
        rope_theta=50_000.0,
        moe=MoEConfig(
            n_experts=384,
            top_k=8,
            d_expert=2048,  # assignment d_ff applies per expert
            n_shared=1,
            d_shared=2048,
            capacity_factor=1.25,
            first_dense_layers=1,
        ),
        source="arXiv:2501.kimi2 (paper table)",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="kimi-k2-1t-a32b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="swiglu",
        moe=MoEConfig(
            n_experts=16,
            top_k=4,
            d_expert=32,
            n_shared=1,
            d_shared=32,
            capacity_factor=1.5,
            first_dense_layers=1,
        ),
        remat=False,
    )
