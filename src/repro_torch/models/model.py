"""Model registry (counterpart of ``repro/models/model.py``).

  model_specs(cfg)                              -> PSpec tree
  model_forward(params, inputs, ctx, cache=None) -> (logits, cache, aux)

with ``inputs = {"tokens": (B, S)}`` and optionally ``"token_mask"`` and
the modality extras, whose frontends are stubs, as in the reference: for
the VLM family ``"embeds"`` (B, S_img, d), precomputed image patch
embeddings, and for the enc-dec family ``"enc_embeds"`` (B, S_enc, d),
precomputed audio frame embeddings.  The port serves every family of the
reference: the dense, MoE and VLM decoders, with GQA or (minicpm3) MLA
attention, the attention-free RWKV-6 family (``ssm``, ``models/rwkv.py``),
the zamba2 hybrid (``hybrid``, ``models/hybrid.py``: Mamba-2 SSD blocks and
a shared attention block) and whisper's encoder-decoder (``encdec``,
``models/encdec.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx


_DECODERS = ("dense", "moe", "vlm")


def model_specs(cfg: ModelConfig) -> dict:
    if cfg.family in _DECODERS:
        from repro_torch.models.transformer import decoder_specs

        return decoder_specs(cfg)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import hybrid_specs

        return hybrid_specs(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import rwkv_lm_specs

        return rwkv_lm_specs(cfg)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import encdec_specs

        return encdec_specs(cfg)
    raise ValueError(cfg.family)


def model_forward(
    params: dict,
    inputs: dict[str, torch.Tensor],
    ctx: Ctx,
    cache: Optional[dict] = None,
):
    """Returns ``(logits, new_cache, aux_loss)``.  ``"token_mask"`` (the
    engine's masked batched prefill) is defined for the attention families'
    slot caches only: the recurrent-state and enc-dec families refuse it."""
    cfg = ctx.cfg
    tokens, token_mask = inputs["tokens"], inputs.get("token_mask")
    if token_mask is not None and cfg.family not in _DECODERS:
        raise NotImplementedError(
            f"token_mask (masked batched prefill) is not supported for "
            f"family {cfg.family!r}: its recurrent/cross caches have no "
            "slot-targeted write form"
        )
    if cfg.family in _DECODERS:
        from repro_torch.models.transformer import forward

        return forward(params, tokens, ctx, cache=cache, embeds=inputs.get("embeds"),
                       token_mask=token_mask)
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import forward

        return forward(params, tokens, ctx, cache=cache)
    if cfg.family == "ssm":
        from repro_torch.models.rwkv import forward

        return forward(params, tokens, ctx, cache=cache)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import forward

        return forward(params, tokens, ctx, enc_embeds=inputs.get("enc_embeds"), cache=cache)
    raise ValueError(cfg.family)
