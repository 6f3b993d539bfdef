"""whisper-tiny: enc-dec, conv frontend (stub).  [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny",
        family="audio",
        n_layers=4,  # decoder depth
        encoder_layers=4,
        d_model=384,
        n_heads=6,
        n_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab=51_865,
        act="gelu",
        tie_embeddings=True,
        frontend="audio",
        frontend_tokens=1500,  # 30 s of audio at 50 Hz after the conv stub
        frontend_dim=384,
        max_seq=33_000,  # learned decoder positions sized for the decode_32k cell
        source="arXiv:2212.04356",
    )


def smoke_config() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny-smoke",
        family="audio",
        n_layers=2,
        encoder_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        act="gelu",
        tie_embeddings=True,
        frontend="audio",
        frontend_tokens=16,
        frontend_dim=64,
        max_seq=64,
        remat=False,
    )
