"""mamba2-130m: attention-free SSD (state-space duality).  [arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig, SSMConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m",
        family="ssm",
        n_layers=24,
        d_model=768,
        n_heads=0,  # attention-free
        n_kv_heads=0,
        head_dim=64,  # SSD head dim
        d_ff=0,
        vocab=50_280,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
        source="arXiv:2405.21060",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-130m-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        head_dim=16,
        d_ff=0,
        vocab=256,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, n_groups=1, chunk=8),
        remat=False,
    )
