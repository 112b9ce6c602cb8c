"""Whisper-base [arXiv:2212.04356]: encoder-decoder; the conv/mel frontend
is a stub, as in the reference: the model takes precomputed frame
embeddings (B, S_enc, d_model)."""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,  # decoder
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    act="gelu",
    pos="sinusoidal",
    attn_bias=True,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, num_heads=4,
        num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512, vocab_pad_multiple=16,
    )
