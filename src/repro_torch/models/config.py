"""Model configuration — one dataclass drives every architecture.

A copy of ``repro/models/config.py`` (which imports no jax), kept here
so the port imports nothing of the JAX package: the same fields,
defaults, ``vocab_padded``, ``counts``, ``reduced`` and
``__post_init__``, so a configuration compares field for field with
the JAX package's.  ``configs/<arch>.py`` instantiates the exact
assigned configuration; ``reduced()`` derives the CPU smoke-test
variant of the same family.  The port runs the dense GQA decoders
(:mod:`repro_torch.models.transformer`); the other families' fields
are kept so the copies stay identical.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int

    # ---- attention (decoder self-attention) ----
    attn_type: str = "gqa"         # gqa | mla | none
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0              # 0 -> d_model // num_heads
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 = full attention

    # ---- MLA (MiniCPM3 / DeepSeek-style latent attention) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ----
    num_experts: int = 0           # routed experts (0 = dense FFN)
    num_experts_padded: int = 0    # padded for mesh divisibility
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # ---- SSM / hybrid ----
    # block pattern: 'A' = attention block, 'M' = mamba2, 'R' = rwkv6,
    # 'S' = *shared*-parameter attention block (Zamba2).  Empty = all 'A'.
    block_pattern: str = ""
    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_width: int = 4

    # ---- encoder-decoder (Whisper) ----
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0           # stub audio frames (1500 for whisper)

    # ---- modality frontend stubs ----
    frontend: str = "none"         # none | vision_stub | audio_stub
    num_patch_tokens: int = 0      # VLM: image patches prepended

    # ---- distribution ----
    # fsdp: params sharded over the data axis too (required when a full
    # model replica does not fit a 16-chip model-parallel group).  The
    # paper's quantized delta aggregation then applies across the POD
    # axis only (see DESIGN.md §4).
    fsdp: bool = False

    # ---- numerics / misc ----
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    # ---- citation (assignment requires source in brackets) ----
    source: str = ""

    # vocab padded up to a multiple of 256 so the vocab dim always
    # divides the 16-way model axis (embedding/lm_head params and
    # logits use the padded size; targets never reference pad ids)
    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.attn_type in ("gqa",) and self.num_heads:
            if self.head_dim == 0:
                object.__setattr__(self, "head_dim",
                                   self.d_model // self.num_heads)
        if self.num_experts and not self.num_experts_padded:
            object.__setattr__(self, "num_experts_padded", self.num_experts)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern", "A" * self.num_layers)
        if len(self.block_pattern) != self.num_layers:
            raise ValueError(
                f"{self.name}: block_pattern length "
                f"{len(self.block_pattern)} != num_layers {self.num_layers}")

    # ---- derived ----
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def rwkv_heads(self) -> int:
        return self.d_model // self.ssm_head_dim

    def counts(self) -> dict:
        """Block-type counts, for param accounting and docs."""
        return {c: self.block_pattern.count(c) for c in "AMRS"}

    def supports_decode(self) -> bool:
        return True  # every assigned arch has a decoder

    def supports_long_context(self) -> bool:
        """long_500k: native for SSM/hybrid; dense via sliding window;
        whisper (enc-dec) skipped — see DESIGN.md."""
        return not self.is_encoder_decoder

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test variant of the same family: 2 layers,
        d_model <= 512, <= 4 experts."""
        pat = self.block_pattern
        # keep family character: take first + a distinctive later block
        distinct = next((c for c in pat if c != pat[0]), pat[0])
        new_pat = pat[0] + distinct
        num_heads = min(self.num_heads, 4) if self.num_heads else 0
        d_model = 256
        kv = min(self.num_kv_heads, num_heads) if self.num_kv_heads else 0
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2,
            block_pattern=new_pat,
            d_model=d_model,
            d_ff=512,
            vocab_size=512,
            num_heads=num_heads,
            num_kv_heads=kv,
            head_dim=64 if num_heads else 0,
            q_lora_rank=min(self.q_lora_rank, 128),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_nope_head_dim=32 if self.attn_type == "mla" else 0,
            qk_rope_head_dim=16 if self.attn_type == "mla" else 0,
            v_head_dim=32 if self.attn_type == "mla" else 0,
            num_experts=min(self.num_experts, 4),
            num_experts_padded=min(self.num_experts_padded, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=min(self.moe_d_ff, 256) if self.moe_d_ff else 0,
            ssm_state_dim=min(self.ssm_state_dim, 16),
            ssm_head_dim=32 if self.ssm_state_dim else 64,
            ssm_chunk=32,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=min(self.encoder_seq, 64),
            num_patch_tokens=min(self.num_patch_tokens, 16),
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
        )


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workloads."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
