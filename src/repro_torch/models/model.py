"""Model registry (counterpart of ``repro/models/model.py``).

  model_specs(cfg)                              -> PSpec tree
  model_forward(params, inputs, ctx, cache=None) -> (logits, cache, aux)

with ``inputs = {"tokens": (B, S)}`` and optionally ``"token_mask"`` and,
for the VLM family, ``"embeds"`` (B, S_img, d): precomputed image patch
embeddings (the vision tower is a stub, as in the reference).  The port
serves the dense, MoE and VLM families so far, with GQA or (minicpm3) MLA
attention; the other families raise until their slices arrive.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx


_FAMILIES = ("dense", "moe", "vlm")


def _check_family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} comes with its own slice of the port"
        )


def model_specs(cfg: ModelConfig) -> dict:
    from repro_torch.models.transformer import decoder_specs

    _check_family(cfg)
    return decoder_specs(cfg)


def model_forward(
    params: dict,
    inputs: dict[str, torch.Tensor],
    ctx: Ctx,
    cache: Optional[dict] = None,
):
    """Returns ``(logits, new_cache, aux_loss)``."""
    from repro_torch.models.transformer import forward

    _check_family(ctx.cfg)
    return forward(
        params,
        inputs["tokens"],
        ctx,
        cache=cache,
        embeds=inputs.get("embeds"),
        token_mask=inputs.get("token_mask"),
    )
