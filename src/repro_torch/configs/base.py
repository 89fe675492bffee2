"""Model configuration schema + the input-shape suite for every arch.

Shapes (assignment):
  train_4k     seq 4096,   global batch 256   (training, lowers train_step)
  prefill_32k  seq 32768,  global batch 32    (inference prefill)
  decode_32k   seq 32768,  global batch 128   (decode: 1 new token, KV cache)
  long_500k    seq 524288, global batch 1     (long-context decode; needs a
                                               sub-quadratic path — see
                                               ``supports_long_context``)
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # 'dense' | 'moe' | 'vlm' | 'audio' | 'hybrid' | 'ssm'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_period: int = 1        # layer l is MoE iff l % moe_period == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # attention
    window: int | None = None  # sliding-window size (None = full)
    qkv_bias: bool = False
    rope_theta: float = 1e6

    # hybrid (Jamba): one attention layer per `attn_period` layers, rest Mamba
    attn_period: int = 0       # 0 = every layer is attention
    attn_offset: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # xLSTM: repeating per-layer block kinds
    block_pattern: tuple[str, ...] = ()  # e.g. ('m','m','m','s')

    # encoder-decoder
    enc_layers: int = 0        # >0 -> enc-dec; n_layers = decoder layers

    # modality frontend stub ('vision' | 'audio' | None): input_specs()
    # provides precomputed patch/frame embeddings of this length
    frontend: str | None = None
    frontend_len: int = 576    # anyres tiles x patches / audio frames

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: str = "block"  # 'block' | 'none' | 'block_save_moe' (keep dispatch)
    seq_parallel: bool = False  # Megatron SP: seq-shard activations between
    #                             layers (RS+AG instead of all-reduce)

    # --- derived -------------------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def layer_kind(self, l: int) -> str:
        """'attn' | 'mamba' | 'slstm' | 'mlstm' for layer l."""
        if self.block_pattern:
            return {"m": "mlstm", "s": "slstm"}[
                self.block_pattern[l % len(self.block_pattern)]
            ]
        if self.attn_period and l % self.attn_period != self.attn_offset:
            return "mamba"
        return "attn"

    def layer_is_moe(self, l: int) -> bool:
        return self.is_moe and l % self.moe_period == self.moe_offset

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path exists: SWA, SSM, or hybrid."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.window is not None

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        pat = self.block_pattern[:4] if self.block_pattern else ()
        return replace(
            self,
            n_layers=max(2, min(4, self.n_layers)) if not self.attn_period
            else self.attn_period,  # keep one full hybrid period
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            window=min(self.window, 64) if self.window else None,
            enc_layers=2 if self.enc_layers else 0,
            frontend_len=8 if self.frontend else self.frontend_len,
            mamba_d_state=8,
            block_pattern=pat,
            dtype="float32",
            remat="none",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether this (arch, shape) cell runs, and why not if skipped."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "pure O(L^2) full attention; no sub-quadratic path (see DESIGN.md)"
    return True, ""
