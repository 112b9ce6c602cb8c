"""Model registry (counterpart of ``repro/models/model.py``).

  model_specs(cfg)                              -> PSpec tree
  model_forward(params, inputs, ctx, cache=None) -> (logits, cache, aux)

with ``inputs = {"tokens": (B, S)}`` and optionally ``"token_mask"`` and,
for the VLM family, ``"embeds"`` (B, S_img, d): precomputed image patch
embeddings (the vision tower is a stub, as in the reference).  The port
serves the dense, MoE and VLM families, with GQA or (minicpm3) MLA
attention, the attention-free RWKV-6 family (``ssm``,
``models/rwkv.py``) and the zamba2 hybrid (``hybrid``, ``models/hybrid.py``:
Mamba-2 SSD blocks and a shared attention block); the enc-dec family raises
until its slice arrives.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx


_DECODERS = ("dense", "moe", "vlm")
_SLICES = {"encdec": "the whisper enc-dec slice"}


def _check_family(cfg: ModelConfig):
    if cfg.family not in _DECODERS + ("ssm", "hybrid"):
        where = _SLICES.get(cfg.family, "its own slice of the port")
        raise NotImplementedError(f"family {cfg.family!r} comes with {where}")


def model_specs(cfg: ModelConfig) -> dict:
    _check_family(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import rwkv_lm_specs

        return rwkv_lm_specs(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import hybrid_specs

        return hybrid_specs(cfg)
    from repro_torch.models.transformer import decoder_specs

    return decoder_specs(cfg)


def model_forward(
    params: dict,
    inputs: dict[str, torch.Tensor],
    ctx: Ctx,
    cache: Optional[dict] = None,
):
    """Returns ``(logits, new_cache, aux_loss)``.  ``"token_mask"`` (the
    engine's masked batched prefill) is defined for the attention families'
    slot caches only: the recurrent-state families refuse it."""
    cfg = ctx.cfg
    _check_family(cfg)
    if cfg.family in ("ssm", "hybrid"):
        if inputs.get("token_mask") is not None:
            raise NotImplementedError(
                f"token_mask (masked batched prefill) is not supported for "
                f"family {cfg.family!r}: its recurrent/cross caches have no "
                "slot-targeted write form"
            )
        if cfg.family == "hybrid":
            from repro_torch.models.hybrid import forward as family_forward
        else:
            from repro_torch.models.rwkv import forward as family_forward

        return family_forward(params, inputs["tokens"], ctx, cache=cache)
    from repro_torch.models.transformer import forward

    return forward(
        params,
        inputs["tokens"],
        ctx,
        cache=cache,
        embeds=inputs.get("embeds"),
        token_mask=inputs.get("token_mask"),
    )
