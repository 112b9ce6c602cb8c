"""Model configuration schema + registry (counterpart of
``repro/configs/base.py``).

One file per architecture lives next to this module; each exports
``CONFIG`` (the published configuration) and ``reduced()`` (a tiny
same-family variant for CPU tests).  The port carries the configurations
of the families it serves so far; others arrive with their slices.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # --- attention ---
    attention: str = "gqa"  # gqa | mla | none
    attn_bias: bool = False
    sliding_window: Optional[int] = None
    rope_theta: float = 10_000.0
    pos: str = "rope"  # rope | sinusoidal | none
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu | gelu
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    router_aux_coef: float = 0.001
    # --- MLA ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM / hybrid ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    conv_kernel: int = 4
    shared_attn_every: int = 0
    # --- RWKV ---
    rwkv_head_dim: int = 64
    decay_lora_rank: int = 64
    # --- enc-dec ---
    encoder_layers: int = 0
    # --- VLM ---
    num_image_tokens: int = 0
    # --- embedding / misc ---
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def q_dim(self) -> int:
        if self.attention == "mla":
            return self.num_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
        return self.num_heads * self.head_dim


ARCH_NAMES = ["granite_8b", "qwen2_moe_a2_7b"]


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCH_NAMES:
        raise NotImplementedError(
            f"config {name!r} comes with its family's slice of the port "
            f"(ported so far: {ARCH_NAMES})"
        )
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.reduced() if reduced else mod.CONFIG
