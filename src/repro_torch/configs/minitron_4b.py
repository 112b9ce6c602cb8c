"""Minitron-4B [arXiv:2407.14679]: width/depth-pruned Nemotron-4."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    act="relu2",  # nemotron squared-ReLU 2-matrix MLP
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, num_heads=6, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
