"""recurrentgemma-2b: hybrid RG-LRU + local attn, pattern (R,R,A).  [arXiv:2402.19427]"""
from repro_torch.configs.base import ArchConfig, HybridConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab=256_000,
        act="swiglu",
        rope_theta=10_000.0,
        hybrid=HybridConfig(
            pattern=("recurrent", "recurrent", "attention"),
            lru_width=2560,
            conv_width=4,
            local_window=2048,
        ),
        source="arXiv:2402.19427",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=5,  # 1 scanned (R,R,A) group + 2-layer recurrent tail
        d_model=64,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab=256,
        act="swiglu",
        hybrid=HybridConfig(
            pattern=("recurrent", "recurrent", "attention"),
            lru_width=64,
            conv_width=4,
            local_window=16,
        ),
        remat=False,
    )
