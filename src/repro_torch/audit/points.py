"""The audited matrix: model config x table family x exec config points
(counterpart of ``repro/audit/points.py``).

The reference audits abstract traces; the port has none, so a point is
built for real -- seeded weights, planned, converted -- and its serving
steps (``serve.make_prefill_step`` / ``make_decode_step``) run once each
under the recorder (:func:`trace_point`): one recording per step, shared
by every rule.  :func:`build_point` / :func:`trace_point` build the
reduced CPU points behind ``python -m repro_torch.audit`` and its
committed baseline: the steps run the kernels' plain versions, which the
rules see op by op.  On a card the steps launch the hand-written kernels,
which the rules see as opaque leaves; ``chip_smoke.py``'s audit phase
builds those full-width points itself and hands them to
:func:`point_artifacts` / :func:`trace_steps` / :func:`audit_artifacts`.

The committed points are the reference's three: the attention weight-table
path (pre-stacked ``LUTGroup`` decode), the TL1 activation-side family on
its exact path, and the MoE expert path (converted expert stacks, the
grouped-product temptation).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.audit.inplace import inplace_violations, state_shapes, storage_map
from repro_torch.audit.ranges import overflow_violations, precision_report
from repro_torch.audit.rules import (
    multiplier_free_violations,
    plan_consistency_violations,
    planned_weight_shapes,
    table_leaf_shapes,
    zero_copy_violations,
)
from repro_torch.audit.walker import OPAQUE_KERNELS, op_census, record


@dataclasses.dataclass(frozen=True)
class AuditPoint:
    """One (model config, table family, exec config) cell of the matrix."""

    name: str
    arch: str
    families: tuple = ("weight",)
    convert_experts: bool = False
    tl1_act_bits: int | None = 8
    batch: int = 1
    cache_len: int = 16
    prefill_len: int = 4


AUDIT_POINTS = (
    # attention weight-table path: grouped fp16 tables, prestacked KV pair
    AuditPoint("granite_weight", "granite_8b", families=("weight",)),
    # TL1 activation-side family: packed ternary tables, exact act mode
    AuditPoint("granite_tl1", "granite_8b", families=("tl1",), tl1_act_bits=None),
    # MoE expert path: converted expert stacks through the ragged LUT route
    AuditPoint(
        "moe_weight_experts",
        "qwen2_moe_a2_7b",
        families=("weight",),
        convert_experts=True,
    ),
)


def point_ctx(cfg):
    """The exec config every point serves under."""
    from repro_torch.models.layers import Ctx, ExecCfg

    return Ctx(cfg, ex=ExecCfg(remat="none", lut_grouped=True))


def build_point(pt: AuditPoint, seed: int = 0) -> dict:
    """One reduced point's artifacts on the CPU: weights from ``seed``, the
    point's plan (chunks capped at 1) with its tiles tuned at the point's
    batch (``attach_tuned_blocks``, as the reference's points attach
    theirs), fp16 tables, a fresh cache, both steps and their seeded
    tokens."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.convert import convert_params
    from repro_torch.core.planner import plan_model
    from repro_torch.kernels.lut_affine.autotune import attach_tuned_blocks
    from repro_torch.models.model import model_specs
    from repro_torch.models.params import init_params

    cfg = get_config(pt.arch, reduced=True)
    params = init_params(model_specs(cfg), torch.Generator().manual_seed(seed), device="cpu")
    mplan = plan_model(
        params,
        float("inf"),
        max_chunk=1,
        families=pt.families,
        convert_experts=pt.convert_experts,
        tl1_act_bits=pt.tl1_act_bits,
    )
    # tuned tiles ride the plan, so the blocks_over_smem rule audits them too
    mplan = attach_tuned_blocks(mplan, pt.batch)
    template, _ = convert_params(
        params, plan=mplan, table_dtype=torch.float16, convert_experts=pt.convert_experts
    )
    gen = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size, (pt.batch, pt.prefill_len), generator=gen,
                           dtype=torch.int32)
    return point_artifacts(pt, cfg, mplan, template, tokens, "cpu", raw=params)


def point_artifacts(pt: AuditPoint, cfg, mplan, template, prefill_tokens, device,
                    raw=None) -> dict:
    """The artifacts :func:`trace_steps` records: the converted tree
    (``template``), its plan, a fresh cache and both steps."""
    from repro_torch.serve import make_cache, make_decode_step, make_prefill_step

    ctx = point_ctx(cfg)
    return {
        "point": pt,
        "cfg": cfg,
        "mplan": mplan,
        "template": template,
        "raw": raw,
        "ctx": ctx,
        "cache": make_cache(cfg, pt.batch, pt.cache_len, ctx, device=device),
        "decode": make_decode_step(ctx),
        "prefill": make_prefill_step(ctx),
        "prefill_tokens": prefill_tokens,
    }


def kernel_launches() -> dict[str, int]:
    """Each kernel's launch count as its wrapper keeps it."""
    from repro_torch.kernels.common import launch_counters

    return {k: n for c in launch_counters() for k, n in c.items() if k in OPAQUE_KERNELS}


def _recorded(fn, *args):
    """``record(fn, *args)`` and the kernel launches its wrappers counted."""
    before = kernel_launches()
    out, ops = record(fn, *args)
    added = {k: n - before[k] for k, n in kernel_launches().items() if n != before[k]}
    return out, ops, added


@torch.no_grad()
def trace_steps(art: dict) -> dict:
    """Record one prefill and one decode step of the point's converted tree
    on the point's cache; returns the recordings
    (``prefill_ops`` / ``decode_ops``), each step's kernel launches as the
    wrappers counted them (``launches``), the in-place verdicts of each
    step and the tokens.  The cache is written in place, as serving
    writes it."""
    params, cache = art["template"], art["cache"]
    shapes = state_shapes(cache)
    before = storage_map(cache)
    (logits, cache), pre_ops, pre_launches = _recorded(
        art["prefill"], params, {"tokens": art["prefill_tokens"]}, cache
    )
    pre_inplace = inplace_violations(before, cache, pre_ops, shapes)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    before = storage_map(cache)
    (next_tok, _, cache), dec_ops, dec_launches = _recorded(art["decode"], params, cache, tok)
    dec_inplace = inplace_violations(before, cache, dec_ops, shapes)
    return {
        "prefill_ops": pre_ops,
        "decode_ops": dec_ops,
        "launches": {"prefill": pre_launches, "decode": dec_launches},
        "inplace": {"prefill": pre_inplace, "decode": dec_inplace},
        "tokens": (tok, next_tok),
    }


def trace_point(pt: AuditPoint) -> dict:
    """Build one reduced CPU point and record its steps ONCE, shared across
    every rule pass (:func:`audit_point` takes the result as ``trace``)."""
    art = build_point(pt)
    art.update(trace_steps(art))
    return art


def vocab_dims(cfg) -> tuple[int, int]:
    """The dims a tied embedding's product carries: exempt from the rules."""
    return (cfg.vocab_size, cfg.padded_vocab)


def audit_artifacts(art: dict) -> dict:
    """Every rule class over one traced point; returns its manifest entry."""
    mplan, template = art["mplan"], art["template"]
    weight_shapes = planned_weight_shapes(mplan)
    table_shapes = table_leaf_shapes(template)
    exempt = vocab_dims(art["cfg"])
    steps = (("decode", art["decode_ops"]), ("prefill", art["prefill_ops"]))
    rules = {
        "multiplier_free": [
            v.to_json()
            for _, ops in steps
            for v in multiplier_free_violations(
                ops, weight_shapes=weight_shapes, table_shapes=table_shapes,
                exempt_dims=exempt,
            )
        ],
        # the zero-copy contract is about the per-token step; prefill may
        # legitimately lay out its prompt-length activations
        "zero_copy": [
            v.to_json()
            for v in zero_copy_violations(art["decode_ops"], table_shapes=table_shapes)
        ],
        "inplace": [v.to_json() for name, _ in steps for v in art["inplace"][name]],
        "plan_consistency": [
            v.to_json()
            for v in plan_consistency_violations(mplan, template, batch=art["point"].batch)
        ],
        # numerical safety: closed-form per-plan certificates + the interval
        # pass over both recorded steps
        "overflow": [v.to_json() for v in overflow_violations(mplan, graphs=steps)],
    }
    return {
        "plan": {
            "layers": len(mplan.layers),
            "groups": len(mplan.groups),
            "families": list(mplan.families),
            "total_lut_bytes": mplan.total_lut_bytes,
        },
        "rules": rules,
        "census": {name: op_census(ops) for name, ops in steps},
        "precision": precision_report(mplan),
    }


def audit_point(pt: AuditPoint, trace: dict | None = None) -> dict:
    """Run every rule class over one point; ``trace`` reuses a
    :func:`trace_point` result instead of recording again."""
    art = trace if trace is not None else trace_point(pt)
    return audit_artifacts(art)
