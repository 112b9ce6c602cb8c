"""Zamba2-style hybrid: a Mamba-2 backbone and one shared-weight
attention + MLP block invoked between segments of SSD layers (counterpart
of ``repro/models/hybrid.py``).

For L mamba layers and the cadence ``shared_attn_every = g`` the layout is

  [g mamba] shared [g mamba] shared ... [remainder mamba]

The shared block's weights are one tree (converted once), but each of its
invocations has its own K/V cache slot, ``shared_attn[i]``, under the one
:class:`~repro_torch.serve._cache.CacheWrite` of the step.  The mamba
layers are stacked along a leading ``layers`` axis, as in the reference,
and the segment loop takes layer ``l``'s views of every leaf; every cache
leaf is written in place.  While autograd records (training), each mamba
layer runs under the ``ExecCfg.remat`` policy (``transformer.remat``); the
shared block does not, as in the reference, which checkpoints only its
mamba scan body.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx
from repro_torch.models.params import PSpec
from repro_torch.models.ssm import mamba_block, mamba_specs


def segments(cfg: ModelConfig) -> list[int]:
    g, n = cfg.shared_attn_every, cfg.num_layers
    segs = [g] * (n // g)
    if n % g:
        segs.append(n % g)
    return segs


def hybrid_specs(cfg: ModelConfig) -> dict:
    from repro_torch.models.transformer import stack_specs

    d = cfg.d_model
    s = {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="embed"),
        "mamba": stack_specs({"ln": L.norm_spec(cfg), "mix": mamba_specs(cfg)}, cfg.num_layers),
        "shared": {
            "ln1": L.norm_spec(cfg),
            "attn": L.attention_specs(cfg),
            "ln2": L.norm_spec(cfg),
            "mlp": L.mlp_specs(cfg),
        },
        "ln_f": L.norm_spec(cfg),
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = L.linear_spec(d, cfg.padded_vocab, axes=("embed", "vocab"))
    return s


def _mamba_apply(lp, x, ctx: Ctx, cache):
    """One mamba layer after its norm, residual added -> (x, new cache)."""
    h, new_c = mamba_block(lp["mix"], L.apply_norm(lp["ln"], x, ctx.cfg), ctx, cache=cache)
    return x + h, new_c


def forward(
    params: dict,
    tokens: torch.Tensor,
    ctx: Ctx,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
):
    """Returns ``(logits, cache, aux)``; ``cache`` (``layers``: each mamba
    layer's ``conv`` and ``state``; ``shared_attn``: each invocation's
    ``k``/``v``; ``pos``/``valid``/``index``) is updated in place."""
    from repro_torch.models.transformer import embed_tokens, lm_logits, remat, unbind_layers
    from repro_torch.serve._cache import advance_meta

    cfg = ctx.cfg
    x = embed_tokens(params, tokens)
    B, S, _ = x.shape
    if positions is None:
        steps = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
        positions = (cache["index"][:, None] + steps if cache is not None
                     else steps.expand(B, S))
    meta = None
    if cache is not None:
        cache, meta = advance_meta(cache, positions, None)

    segs = segments(cfg)
    mamba = unbind_layers(params["mamba"], sum(segs))
    mamba_layer = remat(_mamba_apply, ctx, cache)
    start = 0
    for i, g in enumerate(segs):
        for layer in range(start, start + g):
            lp = mamba[layer]
            lc = ({name: buf[layer] for name, buf in cache["layers"].items()}
                  if cache is not None else None)
            x, new_c = mamba_layer(lp, x, ctx, lc)
            if lc is not None:  # in place, cast to the buffers' dtypes
                for name, new in new_c.items():
                    lc[name].copy_(new)
        start += g
        if i < len(segs) - 1:
            sp = params["shared"]
            lc = None
            if cache is not None:
                lc = {name: buf[i] for name, buf in cache["shared_attn"].items()}
                lc["_meta"] = meta
            x = x + L.attention(sp["attn"], L.apply_norm(sp["ln1"], x, cfg), ctx, positions,
                                cache=lc)
            x = x + L.mlp(sp["mlp"], L.apply_norm(sp["ln2"], x, cfg), ctx)

    x = L.apply_norm(params["ln_f"], x, cfg)
    if ctx.ex.logits == "last":
        x = x[:, -1:]
    logits = lm_logits(params, x, ctx)
    return logits, cache, torch.zeros((), dtype=torch.float32, device=x.device)
