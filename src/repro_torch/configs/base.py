"""Config system: architecture, shape and quantization configs.

Port of ``repro.configs.base``, carried whole: every class here is data.
``PASMQuant.impl`` names the port's dispatch (``dense | dequant | kernel |
pas_kernel``, :func:`repro_torch.core.params.matmul`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["PASMQuant", "MoEConfig", "SSMConfig", "HybridConfig", "ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class PASMQuant:
    """Weight-sharing (PASM) settings — the paper's technique as a config knob.

    ``impl``:
      dense      — no weight sharing (paper's "non-weight-shared" baseline)
      dequant    — weight-shared: indices+codebook in memory, gather→matmul
                   (paper's "weight-shared MAC" baseline; distribution-safe)
      kernel     — fused-dequant GEMM, K1 (production PASM path)
      pas_kernel — paper-faithful PAS two-phase kernel (measurement path)
    """

    enabled: bool = False
    bins: int = 16
    groups: int = 1  # 1 = paper-faithful single dictionary per weight
    impl: str = "dequant"
    quantize_embed: bool = False  # embedding/lm_head tables too
    kv_bits: int = 16  # 8 → int8 PASM-style KV cache (beyond paper)
    min_weight_elems: int = 1 << 16  # don't quantize tiny weights (B ≪ N rule)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_expert: int = 0
    n_shared: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 1  # leading dense-FFN layers (deepseek/kimi style)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style pattern: ``pattern`` per layer, tiled."""

    pattern: Sequence[str] = ("recurrent", "recurrent", "attention")
    lru_width: int = 0
    conv_width: int = 4
    local_window: int = 2048


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 → d_model // n_heads
    act: str = "swiglu"  # swiglu | sq_relu | gelu
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # modality frontends (vit: precomputed patch embeddings; audio: real
    # log-mel + PASM conv stem — repro.models.encdec)
    frontend: str = "none"  # none | vit | audio
    frontend_tokens: int = 0  # patches / frames per example
    frontend_dim: int = 0  # vit embedding dim (projected to d_model)
    n_mels: int = 80  # audio: log-mel channels into the conv stem
    encoder_layers: int = 0  # enc-dec (whisper): encoder depth
    max_seq: int = 8192  # learned-pos archs only (whisper)
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 1024  # KV-chunk for online-softmax attention
    quant: PASMQuant = PASMQuant()
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_quant(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, quant=dataclasses.replace(self.quant, **kw))

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + per-layer), for 6·N·D."""
        D, F, V = self.d_model, self.d_ff, self.vocab
        hd = self.hd
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
        if self.act == "swiglu":
            ffn = 3 * D * F
        else:
            ffn = 2 * D * F
        per_layer = attn + ffn
        n = 0
        if self.moe and self.moe.n_experts:
            m = self.moe
            e_ffn = 3 * D * m.d_expert
            moe_layer = attn + m.n_experts * e_ffn + m.n_shared * 3 * D * m.d_shared + D * m.n_experts
            dense_layers = min(m.first_dense_layers, self.n_layers)
            n += dense_layers * per_layer + (self.n_layers - dense_layers) * moe_layer
        elif self.family == "ssm" and self.ssm:
            s = self.ssm
            d_in = s.expand * D
            per = D * (2 * d_in + 2 * s.n_groups * s.d_state + d_in // s.head_dim) + d_in * D
            n += self.n_layers * per
        elif self.hybrid:
            h = self.hybrid
            w = h.lru_width or D
            rec = D * 2 * w + w * D + 2 * w * h.conv_width + 3 * w  # in/out proj + conv + gates
            n_att = sum(1 for i in range(self.n_layers) if h.pattern[i % len(h.pattern)] == "attention")
            n += n_att * (attn + ffn) + (self.n_layers - n_att) * (rec + ffn)
        else:
            n += self.n_layers * per_layer
        n += V * D * (1 if self.tie_embeddings else 2)
        if self.encoder_layers:
            n += self.encoder_layers * per_layer
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top-k + shared only) for 6·N_active·D."""
        if not (self.moe and self.moe.n_experts):
            return self.n_params()
        D = self.d_model
        hd = self.hd
        m = self.moe
        attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd + self.n_heads * hd * D
        act_ffn = m.top_k * 3 * D * m.d_expert + m.n_shared * 3 * D * m.d_shared
        dense_layers = min(m.first_dense_layers, self.n_layers)
        n = dense_layers * (attn + 3 * D * self.d_ff if self.d_ff else attn + act_ffn)
        n += (self.n_layers - dense_layers) * (attn + act_ffn + D * m.n_experts)
        n += self.vocab * D * 2
        return n


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
