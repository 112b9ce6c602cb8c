"""Mixtral-8x7B [arXiv:2401.04088]: 8 experts top-2, sliding-window attention."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=14336,
    rope_theta=1_000_000.0,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, moe_d_ff=128, vocab_size=512, num_experts=4, num_experts_per_tok=2,
        sliding_window=16, vocab_pad_multiple=16,
    )
