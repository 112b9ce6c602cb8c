"""RWKV-6 "Finch" 3B [arXiv:2404.05892]: attention-free, data-dependent decay."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,  # d_model / rwkv_head_dim
    num_kv_heads=40,
    head_dim=64,
    d_ff=8960,
    vocab_size=65536,
    attention="none",
    rwkv_head_dim=64,
    decay_lora_rank=64,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=224, vocab_size=512, rwkv_head_dim=16, decay_lora_rank=8,
        vocab_pad_multiple=16,
    )
