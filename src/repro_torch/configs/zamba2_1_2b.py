"""Zamba2-1.2B [arXiv:2411.15242]: Mamba2 backbone + shared attention block."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,  # mamba2 layers; shared attn+mlp every 6
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    mamba_head_dim=64,
    mamba_expand=2,
    conv_kernel=4,
    shared_attn_every=6,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512, ssm_state=16, mamba_head_dim=16,
        shared_attn_every=2, vocab_pad_multiple=16,
    )
