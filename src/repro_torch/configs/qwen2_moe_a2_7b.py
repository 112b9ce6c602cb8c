"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=5632,  # shared-expert dense branch width (4 x 1408)
    vocab_size=151936,
    attn_bias=True,
    num_experts=60,
    num_experts_per_tok=4,
    moe_d_ff=1408,
    num_shared_experts=4,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, num_experts=8, num_experts_per_tok=4, moe_d_ff=32,
        num_shared_experts=2, vocab_pad_multiple=16,
    )
