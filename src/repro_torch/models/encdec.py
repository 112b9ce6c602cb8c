"""Whisper-style encoder-decoder (counterpart of ``repro/models/encdec.py``).

The conv/mel frontend is a stub, as in the reference: the model takes
precomputed frame embeddings (B, S_enc, d).  The encoder is
bidirectional with sinusoidal positions; the decoder runs causal
self-attention, cross-attention over the encoder's output and a biased
GELU MLP, each after a LayerNorm, and its head is the token embedding's
transpose (tied, a plain product, not a LUT).

With a cache, the prefill (``enc_embeds`` given) encodes the frames and
writes every decoder layer's cross K/V into ``cache["cross"]`` in place,
in the reference's order: the encoder, then the cross K/V of each layer,
then the decoder blocks.  They are static afterwards: decode steps read
them and write only the self K/V.  Without a cache each layer computes its
cross K/V from the encoder's output between its self- and
cross-attention, as the reference's training path does, so that the
gradient reaches the encoder through every layer's cross K/V.  Layer
parameters are stacked along a leading ``layers`` axis; the loops take
layer ``l``'s views of every leaf.  While autograd records (training),
each encoder and decoder layer runs under the ``ExecCfg.remat`` policy
(``transformer.remat``), as the reference checkpoints both scan bodies.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx
from repro_torch.models.params import PSpec
from repro_torch.models.transformer import (
    embed_tokens,
    lm_logits,
    remat,
    stack_specs,
    unbind_layers,
)


def encdec_specs(cfg: ModelConfig) -> dict:
    enc_block = {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_specs(cfg),
    }
    dec_block = {
        "ln1": L.norm_spec(cfg),
        "self_attn": L.attention_specs(cfg),
        "ln_x": L.norm_spec(cfg),
        "cross_attn": L.attention_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "mlp": L.mlp_specs(cfg),
    }
    return {
        "embed": PSpec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"), init="embed"),
        "encoder": stack_specs(enc_block, cfg.encoder_layers),
        "enc_ln_f": L.norm_spec(cfg),
        "decoder": stack_specs(dec_block, cfg.num_layers),
        "ln_f": L.norm_spec(cfg),
        # whisper ties the output head to the token embedding
    }


def encode(params: dict, enc_embeds: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The bidirectional encoder over (B, S, d) frame embeddings: each
    layer's ``wq``/``wk``/``wv`` over one packed input, attention with a
    full-visibility mask, ``wo``, then the MLP."""
    cfg = ctx.cfg
    B, S, d = enc_embeds.shape
    pos = L.sinusoidal_embedding(S, d, device=enc_embeds.device)
    x = enc_embeds + pos[None].to(enc_embeds.dtype)
    mask = torch.ones((B, 1, S, S), dtype=torch.bool, device=x.device)
    layer = remat(_encoder_layer, ctx)
    for lp in unbind_layers(params["encoder"], cfg.encoder_layers):
        x = layer(lp, x, ctx, mask)
    return L.apply_norm(params["enc_ln_f"], x, cfg)


def _encoder_layer(lp: dict, x, ctx: Ctx, mask):
    cfg = ctx.cfg
    h = L.apply_norm(lp["ln1"], x, cfg)
    yq, yk, yv = L.fused_linears(lp["attn"], ("wq", "wk", "wv"), h, ctx)
    q = L._split_heads(yq, cfg.num_heads)
    k = L._split_heads(yk, cfg.num_kv_heads)
    v = L._split_heads(yv, cfg.num_kv_heads)
    x = x + L.linear(lp["attn"]["wo"], L._sdpa(q, k, v, mask), ctx)
    return x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), ctx)


def _cross_kv_from(p: dict, enc_out: torch.Tensor, ctx: Ctx):
    """One decoder layer's cross K/V (B, S_enc, K, hd) from the encoder's
    output: ``wk`` and ``wv`` over one packed input (the members of a
    ``wq+wk+wv`` group run alone on its leaf)."""
    yk, yv = L.fused_linears(p, ("wk", "wv"), enc_out, ctx)
    K = ctx.cfg.num_kv_heads
    return L._split_heads(yk, K), L._split_heads(yv, K)


def decode_blocks(params: dict, x, ctx: Ctx, positions, cache=None, meta=None, enc_out=None):
    """The decoder blocks: self-attention (its K/V written to
    ``cache["layers"]`` in place), cross-attention over the cache's static
    cross K/V or, without a cache, over ``enc_out``'s, then the MLP."""
    layer = remat(_decoder_layer, ctx, cache)
    for i, lp in enumerate(unbind_layers(params["decoder"], ctx.cfg.num_layers)):
        lc = ckv = None
        if cache is not None:
            lc = {name: buf[i] for name, buf in cache["layers"].items()}
            lc["_meta"] = meta
            ckv = (cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = layer(lp, x, ctx, positions, lc, ckv, enc_out)
    return x


def _decoder_layer(lp: dict, x, ctx: Ctx, positions, cache, cross_kv, enc_out):
    """One decoder layer over the static ``cross_kv`` (serving) or, when it
    is None, the cross K/V recomputed from ``enc_out``."""
    cfg = ctx.cfg
    x = x + L.attention(lp["self_attn"], L.apply_norm(lp["ln1"], x, cfg), ctx, positions,
                        cache=cache)
    h = L.apply_norm(lp["ln_x"], x, cfg)
    if cross_kv is None:
        cross_kv = _cross_kv_from(lp["cross_attn"], enc_out, ctx)
    x = x + L.attention(lp["cross_attn"], h, ctx, positions, cross_kv=cross_kv)
    return x + L.mlp(lp["mlp"], L.apply_norm(lp["ln2"], x, cfg), ctx)


def forward(
    params: dict,
    tokens: torch.Tensor,  # (B, S_dec)
    ctx: Ctx,
    enc_embeds: Optional[torch.Tensor] = None,  # (B, S_enc, d); None at decode
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
):
    """Returns ``(logits, cache, aux)``; ``cache`` (``layers``: the decoder's
    self K/V, dense or paged; ``cross``: the static cross K/V, fp32 at
    S_enc; ``pos``/``valid``/``index``) is updated in place.  A prefill
    gives ``enc_embeds``, whose length must be the cache's cross length."""
    from repro_torch.serve._cache import advance_meta

    cfg = ctx.cfg
    x = embed_tokens(params, tokens)
    B, S, _ = x.shape
    if positions is None:
        steps = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        positions = (cache["index"][:, None] + steps if cache is not None
                     else steps.expand(B, S))
    # decoder positions: sinusoidal at absolute positions (the reference's
    # stand-in for whisper's learned table)
    x = x + L.sinusoidal_at(positions, cfg.d_model).to(x.dtype)

    meta = enc_out = None
    if cache is not None:
        cache, meta = advance_meta(cache, positions, None)
        if enc_embeds is not None:  # prefill: fill the cross cache
            cross = cache["cross"]
            if cross["k"].shape[2] != enc_embeds.shape[1]:
                raise ValueError(
                    f"{enc_embeds.shape[1]} encoder frames, but the cache holds cross K/V "
                    f"for {cross['k'].shape[2]}: make the cache with enc_len="
                    f"{enc_embeds.shape[1]}"
                )
            enc_out = encode(params, enc_embeds, ctx)
            layers = unbind_layers(params["decoder"]["cross_attn"], cfg.num_layers)
            for i, lp in enumerate(layers):
                k, v = _cross_kv_from(lp, enc_out, ctx)
                cross["k"][i].copy_(k)
                cross["v"][i].copy_(v)
    else:
        if enc_embeds is None:
            raise ValueError("an enc-dec forward without a cache needs enc_embeds")
        enc_out = encode(params, enc_embeds, ctx)

    x = decode_blocks(params, x, ctx, positions, cache, meta, enc_out)
    x = L.apply_norm(params["ln_f"], x, cfg)
    if ctx.ex.logits == "last":
        x = x[:, -1:]
    return lm_logits(params, x, ctx), cache, torch.zeros((), dtype=torch.float32,
                                                         device=x.device)
