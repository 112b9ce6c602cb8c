"""Decoder-only transformer LM, dense and MoE families (counterpart of
``repro/models/transformer.py``).

Layer parameters are stacked along a leading ``layers`` axis, as in the
reference; the block loop takes layer ``l``'s views of every leaf
(``tables[l]``, ``w[l]``, cache ``k[l]``) -- nothing is re-stacked.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import LUTGroup, LUTLinear
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.params import PSpec, tree_map


def stack_specs(tree, n: int):
    """Prepend a (n,)+"layers" axis to every PSpec in a block's tree."""
    return tree_map(
        lambda s: PSpec((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale, s.dtype),
        tree,
    )


def block_specs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.norm_spec(cfg),
        "attn": L.attention_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "ffn": moe_specs(cfg) if cfg.num_experts else L.mlp_specs(cfg),
    }


def decoder_specs(cfg: ModelConfig) -> dict:
    if cfg.attention != "gqa" or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            "MLA attention and layernorm come with their slices of the port"
        )
    if cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window rings come with the mixtral slice")
    d = cfg.d_model
    s: dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="embed"),
        "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
        "ln_f": L.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = L.linear_spec(d, cfg.padded_vocab, axes=("embed", "vocab"))
    return s


def layer_params(tree, i: int):
    """Layer ``i``'s views of a stacked block tree."""
    if isinstance(tree, dict):
        return {k: layer_params(v, i) for k, v in tree.items()}
    if isinstance(tree, (LUTLinear, LUTGroup)):
        return tree.layer(i)
    return tree[i]


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.to(torch.int64)]


def lm_logits(params: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    if ctx.cfg.tie_embeddings:
        return x @ params["embed"].T
    return L.linear(params["lm_head"], x, ctx)


def _block_apply(p, x, ctx: Ctx, positions, layer_cache):
    """One block -> (x, the router's aux loss: 0 for a dense FFN)."""
    cfg = ctx.cfg
    h = L.apply_norm(p["ln1"], x, cfg)
    x = x + L.attention(p["attn"], h, ctx, positions, cache=layer_cache)
    h = L.apply_norm(p["ln2"], x, cfg)
    if cfg.num_experts:
        h, aux = moe_ffn(p["ffn"], h, ctx)
        return x + h, aux
    return x + L.mlp(p["ffn"], h, ctx), None


def forward(
    params: dict,
    tokens: torch.Tensor,  # (B, S) int32
    ctx: Ctx,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    token_mask: Optional[torch.Tensor] = None,  # (B, S) bool: real tokens
):
    """Returns ``(logits, cache, aux_loss)``; ``cache`` is updated in place
    and ``aux_loss`` is the routers' load-balance loss summed over layers.

    ``token_mask`` marks real tokens in a right-padded batch: masked
    positions write nothing into the cache and do not advance the per-slot
    index, so all-False rows keep their cache state untouched."""
    from repro_torch.serve._cache import advance_meta

    x = embed_tokens(params, tokens)
    B, S, _ = x.shape
    if positions is None:
        steps = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        if cache is not None:
            positions = cache["index"][:, None] + steps
        else:
            positions = steps.expand(B, S)
    meta = None
    if cache is not None:
        cache, meta = advance_meta(
            cache, positions, ctx.cfg.sliding_window, token_mask
        )
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(ctx.cfg.num_layers):
        lc = None
        if cache is not None:
            lc = {name: buf[i] for name, buf in cache["layers"].items()}
            lc["_meta"] = meta
        lp = layer_params(params["blocks"], i)
        x, layer_aux = _block_apply(lp, x, ctx, positions, lc)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = L.apply_norm(params["ln_f"], x, ctx.cfg)
    if ctx.ex.logits == "last":
        x = x[:, -1:]
    return lm_logits(params, x, ctx), cache, aux
