"""Mixture-of-experts FFN on one GPU: top-k routing and expert-sorted
execution (counterpart of ``repro/models/moe.py`` without its mesh).

Expert execution dispatches per projection on the parameter leaf:

* raw ``(E, q, p)`` tensors  -> a dense grouped product (the stand-in for
  ``lax.ragged_dot``: every row against its own expert's weights)
* :class:`LUTLinear` / :class:`LUTGroup` of the weight family -> the
  ragged LUT path, ``kernels.lut_affine.ops.lut_affine_experts`` (gate
  and up of a pre-stacked pair in one launch)
* TL1-planned nodes -> :func:`_ragged_tl1`, plain PyTorch on every path
  (the reference has no kernel for it either)

A token's LUT input decomposition does not depend on its expert, so codes
are packed ONCE per token and then gathered into the expert-sorted order.
Qwen2-MoE shared experts run as a dense SwiGLU branch (its projections on
the LUT kernels when converted) under a sigmoid gate, and the router's
load-balance loss is returned beside the output.

Nothing here reads the device back: group sizes are counted with
``scatter_add_`` on the device, the sort is ``argsort(stable=True)``
(jnp's argsort is stable, so rows within an expert keep the reference's
order), and the combine inverts the sort permutation and sums each
token's k rows in a fixed order instead of a float ``index_add_``, whose
atomics would add in no fixed order.  The expert-parallel ``shard_map``
of the reference waits for the distribution slice.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import LUTGroup, LUTLinear
from repro_torch.core.lut import LUTPlan, plane_scales
from repro_torch.core.lut_tl1 import (
    TL1Plan,
    build_act_lut,
    quantize_acts,
    unpack_indices,
)
from repro_torch.kernels.bitplane_pack.ops import pack
from repro_torch.kernels.common import check_acc_contract
from repro_torch.kernels.lut_affine.ops import lut_affine_experts
from repro_torch.models.layers import Ctx, ExecCfg, mlp, mlp_specs
from repro_torch.models.params import PSpec

_GATHER_BYTES = 1 << 30


def moe_specs(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = {
        "router": PSpec((d, E), ("embed", None), dtype=torch.float32),
        "w_gate": PSpec((E, d, f), ("experts", "embed", "mlp")),
        "w_up": PSpec((E, d, f), ("experts", "embed", "mlp")),
        "w_down": PSpec((E, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.num_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.num_shared_experts * cfg.moe_d_ff)
        s["shared_gate"] = PSpec((d, 1), ("embed", None), dtype=torch.float32)
    return s


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """(T, d) -> combine weights (T, k), expert ids (T, k) int64, aux loss.
    The router product stays an fp32 ``matmul``, as the reference leaves
    it to XLA; a router cast to bf16 for a training step's compute widens
    to fp32 there, as jnp's promotion does."""
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    weights, idx = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    weights = weights / weights.sum(-1, keepdim=True)
    # Switch-style load-balance loss: E * sum_e f_e * P_e
    E, T = cfg.num_experts, x.shape[0]
    counts = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, idx.reshape(-1), torch.ones(idx.numel(), device=x.device))
    f_e = counts / T
    P_e = probs.mean(dim=0)
    aux = E * torch.sum(f_e * P_e)
    return weights.to(x.dtype), idx, aux


def dispatch(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig):
    """Route ``x`` (T, d) and sort its (T*k) expert rows by expert, on the
    device: ``(weights (T, k), aux, order, token_of, group_sizes)``, where
    sorted row i is flat row ``order[i]`` of token ``token_of[i]`` and
    ``group_sizes[e]`` counts expert e's rows."""
    weights, idx, aux = _route(x, router_w, cfg)
    flat = idx.reshape(-1)  # (T*k,)
    order = torch.argsort(flat, stable=True)
    group_sizes = torch.zeros(cfg.num_experts, dtype=torch.int64, device=x.device)
    group_sizes.scatter_add_(0, flat, torch.ones_like(flat))
    return weights, aux, order, order // cfg.num_experts_per_tok, group_sizes


def _member_node(experts: dict, name: str):
    """A projection by name, stored per name or inside a pre-stacked expert
    :class:`LUTGroup` (``"w_gate+w_up"``)."""
    if name in experts:
        return experts[name]
    for node in experts.values():
        if isinstance(node, LUTGroup) and name in node.members:
            return node
    raise KeyError(name)


def _ragged_lut(
    tables: torch.Tensor,  # (E, G, k, entries, p)
    plan: LUTPlan,
    codes: torch.Tensor,  # (T, n, k) expert-sorted
    group_sizes: torch.Tensor,  # (E,)
    ex: ExecCfg,
    scale=None,  # the layer's narrow-table dequant scale (host)
) -> torch.Tensor:
    """(G, T, p) fp32: every row against ITS expert's tables."""
    check_acc_contract("lut_affine_experts", plan, "float32")
    scales = plane_scales(plan).astype(np.float32)
    if scale is not None:  # power-of-2 dequant folds into the plane scales
        scales = scales * np.float32(float(scale))
    return lut_affine_experts(
        codes, tables, scales, group_sizes, shift_bits=plan.shift_bits, plan=plan,
        blocks=plan.blocks, use_kernels=ex.use_kernels,
    )


def _ragged_tl1(
    tables: torch.Tensor,  # (E, G, kb, p) uint8 packed base-3 indices
    plan: TL1Plan,
    acts: torch.Tensor,  # (T, 4*kb) expert-sorted activation codes
    group_sizes: torch.Tensor,  # (E,)
    scale: torch.Tensor | None = None,  # (E, G) per-expert ternary scales
    act_scale: torch.Tensor | None = None,  # (T, 1) expert-sorted, int path
    max_gather_bytes: int = _GATHER_BYTES,
) -> torch.Tensor:
    """(G, T, p) fp32, TL1 twin of :func:`_ragged_lut`: the activation LUT
    is per token, so the expert only selects which packed index matrix a
    row gathers from.  Plain PyTorch, in token slices of at most
    ``max_gather_bytes``; the int path sums in int32, exactly."""
    check_acc_contract(
        "ragged_tl1", plan, "int32" if plan.act_bits is not None else "float32"
    )
    E, G, kb, p = tables.shape
    T = acts.shape[0]
    expert_of = torch.repeat_interleave(
        torch.arange(E, device=acts.device), group_sizes, output_size=T
    )
    idx = unpack_indices(tables, torch.int64)  # (E, G, 2kb, p)
    lut = build_act_lut(acts)  # (T, 2kb, 9)
    acc = torch.float32 if lut.is_floating_point() else torch.int32
    out = torch.empty((G, T, p), dtype=acc, device=acts.device)
    step = max(1, max_gather_bytes // max(1, G * 2 * kb * p * 16))
    for t0 in range(0, T, step):
        t1 = min(T, t0 + step)
        rows = idx[expert_of[t0:t1]]  # (Ts, G, 2kb, p)
        src = lut[t0:t1, None].expand(-1, G, -1, -1)  # (Ts, G, 2kb, 9)
        g = torch.gather(src, -1, rows)
        out[:, t0:t1] = g.to(acc).sum(dim=-2).movedim(0, 1)
    out = out.to(torch.float32)
    if act_scale is not None:
        out = out * act_scale[None]  # (1, T, 1)
    if scale is not None:
        out = out * scale[expert_of].movedim(0, 1)[..., None]  # (G, T, 1)
    return out


def _ragged_dense(
    rows: torch.Tensor,  # (T, q) expert-sorted
    w: torch.Tensor,  # (E, q, p)
    expert_of: torch.Tensor,  # (T,)
) -> torch.Tensor:
    """(T, p): each row times its own expert's weights, the stand-in for
    ``lax.ragged_dot``.  Every expert's product of all rows, then each
    row's own picked out: E times the work, no per-expert loop and no
    host read of the group sizes (the converted path, not this one, is
    what serving runs)."""
    full = torch.matmul(rows[None], w)  # (E, T, p)
    return full[expert_of, torch.arange(rows.shape[0], device=rows.device)]


def _moe_local(x: torch.Tensor, experts: dict, cfg: ModelConfig, ex: ExecCfg):
    """(T, d) -> (T, d), aux.  Dispatches per projection on the leaf type,
    so dense, converted and mixed expert trees all run."""
    k, T = cfg.num_experts_per_tok, x.shape[0]
    weights, aux, order, token_of, group_sizes = dispatch(x, experts["router"], cfg)

    # one packing (or TL1 quantization) per token and plan, gathered into
    # the expert-sorted order; TL1 entries hold (codes, act_scale)
    pack_cache: dict = {}

    def sorted_codes(plan: LUTPlan, src: torch.Tensor, gather: bool) -> torch.Tensor:
        if gather:  # src is (T, d): pack per token, gather to (T*k, n, kc)
            if plan not in pack_cache:
                pack_cache[plan] = pack(src, plan, use_kernels=ex.use_kernels)
            return pack_cache[plan][token_of]
        # src already expert-sorted (h)
        return pack(src, plan, use_kernels=ex.use_kernels)

    def sorted_tl1(plan: TL1Plan, src: torch.Tensor, gather: bool):
        if gather:
            if plan not in pack_cache:
                pack_cache[plan] = quantize_acts(src, plan)
            codes, ascale = pack_cache[plan]
            return codes[token_of], None if ascale is None else ascale[token_of]
        return quantize_acts(src, plan)

    def project(name: str, src: torch.Tensor, gather: bool) -> torch.Tensor:
        """One expert projection over the expert-sorted rows."""
        node = _member_node(experts, name)
        if isinstance(node, (LUTGroup, LUTLinear)):
            if isinstance(node, LUTGroup):
                g = node.members.index(name)
                tables = node.tables[:, g : g + 1]
            else:
                tables = node.tables[:, None]
            if isinstance(node.plan, TL1Plan):
                codes, ascale = sorted_tl1(node.plan, src, gather)
                scale = node.scale[:, g : g + 1] if isinstance(node, LUTGroup) \
                    else node.scale[:, None]
                y = _ragged_tl1(
                    tables, node.plan, codes, group_sizes, scale=scale, act_scale=ascale
                )
            else:
                codes = sorted_codes(node.plan, src, gather)
                y = _ragged_lut(
                    tables, node.plan, codes, group_sizes, ex, scale=node.scale
                )
            return y[0].to(x.dtype)
        rows = src[token_of] if gather else src
        expert_of = torch.repeat_interleave(
            torch.arange(cfg.num_experts, device=x.device), group_sizes,
            output_size=rows.shape[0],
        )
        return _ragged_dense(rows, node, expert_of)

    gate_node = _member_node(experts, "w_gate")
    up_node = _member_node(experts, "w_up")
    if isinstance(gate_node, LUTGroup) and gate_node is up_node:
        # the pre-stacked gate/up pair: ONE ragged launch for both
        plan = gate_node.plan
        if isinstance(plan, TL1Plan):
            codes, ascale = sorted_tl1(plan, x, gather=True)
            gu = _ragged_tl1(
                gate_node.tables, plan, codes, group_sizes, scale=gate_node.scale,
                act_scale=ascale,
            )
        else:
            codes = sorted_codes(plan, x, gather=True)
            gu = _ragged_lut(
                gate_node.tables, plan, codes, group_sizes, ex, scale=gate_node.scale
            )
        members = gate_node.members
        g = gu[members.index("w_gate")].to(x.dtype)
        u = gu[members.index("w_up")].to(x.dtype)
    else:
        g = project("w_gate", x, gather=True)
        u = project("w_up", x, gather=True)
    h = F.silu(g) * u  # (T*k, f)
    y = project("w_down", h, gather=False)  # (T*k, d), expert-sorted
    # back to token order: row order[i] of the flat (T*k) layout is sorted
    # row i, so inverting the permutation puts each token's k rows together
    inv = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device)
    )
    combine = weights.reshape(-1, 1).to(y.dtype)
    out = (y[inv] * combine).reshape(T, k, -1).sum(dim=1)
    return out, aux


def moe_ffn(p: dict, x: torch.Tensor, ctx: Ctx):
    """(B, S, d) -> (B, S, d), aux_loss."""
    B, S, d = x.shape
    experts = {k: v for k, v in p.items() if k not in ("shared", "shared_gate")}
    out, aux = _moe_local(x.reshape(B * S, d), experts, ctx.cfg, ctx.ex)
    out = out.reshape(B, S, d)
    if "shared" in p:
        gate = x.to(torch.float32) @ p["shared_gate"].to(torch.float32)
        gate = torch.sigmoid(gate).to(x.dtype)
        out = out + gate * mlp(p["shared"], x, ctx)
    return out, aux
