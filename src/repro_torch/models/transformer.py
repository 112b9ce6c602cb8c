"""Decoder-only transformer LM, dense, MoE and VLM families, GQA or MLA
attention (counterpart of ``repro/models/transformer.py``).

Layer parameters are stacked along a leading ``layers`` axis, as in the
reference; the block loop takes layer ``l``'s views of every leaf
(``tables[l]``, ``w[l]``, a cache leaf's ``[l]``) -- nothing is re-stacked.
While autograd records (training), each block runs under
``torch.utils.checkpoint`` by the ``ExecCfg.remat`` policy (:func:`remat`,
which the other families' layer loops share), as the reference wraps its
scan body in ``jax.checkpoint``.
"""
from __future__ import annotations

import functools
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
        "attn": L.mla_specs(cfg) if cfg.attention == "mla" else L.attention_specs(cfg),
        "ln2": L.norm_spec(cfg),
        "ffn": moe_specs(cfg) if cfg.num_experts else L.mlp_specs(cfg),
    }


def decoder_specs(cfg: ModelConfig) -> dict:
    if cfg.attention not in ("gqa", "mla") or cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"{cfg.attention!r} attention with {cfg.norm!r} comes with its slice of the "
            "port (ported: 'gqa' and 'mla' with 'rmsnorm')"
        )
    d = cfg.d_model
    s: dict[str, Any] = {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="embed"),
        "blocks": stack_specs(block_specs(cfg), cfg.num_layers),
        "ln_f": L.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = L.linear_spec(d, cfg.padded_vocab, axes=("embed", "vocab"))
    return s


def unbind_layers(tree, n: int) -> list:
    """The first ``n`` layers' views of a stacked block tree, each tensor
    leaf split by one ``unbind``: under autograd its backward stacks the
    layers' gradients in one op, where ``n`` separate indexings would each
    add a zero-padded gradient of the whole stacked leaf.  Every family's
    block loop takes its layers' views here."""
    if isinstance(tree, dict):
        parts = {k: unbind_layers(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    if isinstance(tree, (LUTLinear, LUTGroup)):
        return [tree.layer(i) for i in range(n)]
    return list(torch.unbind(tree))[:n]


def layer_params(tree, i: int):
    """Layer ``i``'s views of a stacked block tree (one layer's tables or
    weights, outside a block loop)."""
    return unbind_layers(tree, i + 1)[i]


# the ops whose outputs the selective remat policies keep (torch's
# counterparts of jax.checkpoint_policies.checkpoint_dots and
# checkpoint_dots_with_no_batch_dims): a projection's ``x @ W`` dispatches
# as mm / addmm, attention's einsums as bmm
_DOTS = {
    "dots": ("mm", "addmm", "bmm", "baddbmm"),
    "dots_no_batch": ("mm", "addmm"),
}


def _remat_context(name: str):
    """``torch.utils.checkpoint``'s ``context_fn`` for remat policy
    ``name`` (``"full"``: save nothing, the default context)."""
    from torch.utils.checkpoint import (
        CheckpointPolicy,
        create_selective_checkpoint_contexts,
        noop_context_fn,
    )

    if name == "full":
        return noop_context_fn
    saved = {getattr(torch.ops.aten, op).default for op in _DOTS[name]}

    def policy(ctx, op, *args, **kwargs):
        if op in saved:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat(fn, ctx: Ctx, cache=None):
    """``fn``, or ``fn`` under ``torch.utils.checkpoint`` by the
    ``ExecCfg.remat`` policy while autograd records and no cache is given
    (a cache's in-place writes stay outside autograd).  Every family's
    layer loop calls its layer body through this, as the reference wraps
    its scan bodies in ``jax.checkpoint``."""
    if ctx.ex.remat == "none" or not torch.is_grad_enabled() or cache is not None:
        return fn
    from torch.utils.checkpoint import checkpoint

    return functools.partial(
        checkpoint, fn, use_reentrant=False, context_fn=_remat_context(ctx.ex.remat),
        preserve_rng_state=False,
    )


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
    attend = L.mla_attention if cfg.attention == "mla" else L.attention
    x = x + attend(p["attn"], h, ctx, positions, cache=layer_cache)
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
    embeds: Optional[torch.Tensor] = None,  # VLM: (B, S_img, d) patch embeddings
):
    """Returns ``(logits, cache, aux_loss)``; ``cache`` is updated in place
    and ``aux_loss`` is the routers' load-balance loss summed over layers.

    ``token_mask`` marks real tokens in a right-padded batch: masked
    positions write nothing into the cache and do not advance the per-slot
    index, so all-False rows keep their cache state untouched.  ``embeds``
    (VLM) go before the tokens (the llava layout) and count as real tokens:
    they take positions 0..S_img-1 and advance the cache index."""
    from repro_torch.serve._cache import advance_meta

    x = embed_tokens(params, tokens)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
        if token_mask is not None:
            img = torch.ones(embeds.shape[:2], dtype=torch.bool, device=x.device)
            token_mask = torch.cat([img, token_mask], dim=1)
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
    block = remat(_block_apply, ctx, cache)
    blocks = unbind_layers(params["blocks"], ctx.cfg.num_layers)
    for i, lp in enumerate(blocks):
        lc = None
        if cache is not None:
            lc = {name: buf[i] for name, buf in cache["layers"].items()}
            lc["_meta"] = meta
        x, layer_aux = block(lp, x, ctx, positions, lc)
        if layer_aux is not None:
            aux = aux + layer_aux
    x = L.apply_norm(params["ln_f"], x, ctx.cfg)
    if ctx.ex.logits == "last":
        x = x[:, -1:]
    return lm_logits(params, x, ctx), cache, aux
