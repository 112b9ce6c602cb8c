"""Phi-3-medium-14B [arXiv:2404.14219]: RoPE + SwiGLU + GQA (kv=10)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=10,
    head_dim=128,
    d_ff=17920,
    vocab_size=100352,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=80, num_heads=5, num_kv_heads=5, head_dim=16,
        d_ff=160, vocab_size=512, vocab_pad_multiple=16,
    )
