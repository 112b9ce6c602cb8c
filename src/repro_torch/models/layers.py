"""Shared model layers for the dense decoder (counterpart of the dense
half of ``repro/models/layers.py``): norms, RoPE, linears with the TableNet
LUT path, GQA attention over a dense KV cache, the gated MLP and sampling.

Every projection goes through :func:`linear` (or :func:`fused_linears` for
sibling projections over one input).  Converted trees carry
``core.convert`` :class:`LUTLinear` / pre-stacked :class:`LUTGroup`
nodes, which run on the Hopper kernels by their plan's table family:
weight-side tables through ``kernels.lut_affine.ops``, their input packed
into the plan's LUT codes by ``kernels.bitplane_pack.ops.pack`` (one
launch per pack); TL1 activation-side tables through
``kernels.lut_tl1.ops`` (``ExecCfg.use_kernels``; on CPU tensors the
wrappers run the plain versions).  Under
``ExecCfg(linear_mode="binary_matmul")`` the unconverted projections run
the beyond-paper bitplane path against their original weights: the input
is packed into 8/6 fixed-point bitplanes (``kernels.bitplane_pack``) and
the tensor cores sum the planes' products (``kernels.binary_matmul``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.convert import LUTGroup, LUTLinear
from repro_torch.core.lut import LUTPlan, plane_scales
from repro_torch.core.lut_tl1 import TL1Plan, quantize_acts
from repro_torch.core.quantize import FixedPointFormat
from repro_torch.kernels.binary_matmul.ops import binary_matmul
from repro_torch.kernels.bitplane_pack.ops import bitplane_pack, pack
from repro_torch.kernels.lut_affine.ops import lut_affine, lut_affine_grouped
from repro_torch.kernels.lut_tl1.ops import lut_tl1, lut_tl1_grouped
from repro_torch.models.params import PSpec


@dataclasses.dataclass(frozen=True)
class ExecCfg:
    """Execution options.

    ``linear_mode`` is how unconverted projections run: ``"standard"``
    (and ``"lut_gather"``, the same, as in the reference) is ``x @ W``;
    ``"binary_matmul"`` packs the input into ``fixed_bits``/``fixed_frac``
    signed fixed-point bitplanes and sums ``scale_j * planes_j @ bf16(W)``
    in fp32.  Converted projections take their LUT path in every mode.
    ``use_kernels`` runs the projections on the Hopper kernels when their
    inputs lie on the card (False asks for the plain PyTorch versions);
    ``lut_grouped`` fuses a pre-stacked group's projections into one
    grouped launch; ``logits="last"`` keeps only the final position's
    head."""

    linear_mode: str = "standard"  # standard | lut_gather | binary_matmul
    fixed_bits: int = 8  # binary_matmul input format
    fixed_frac: int = 6
    lut_grouped: bool = False
    use_kernels: bool = True
    logits: str = "all"  # all | last

    def __post_init__(self):
        if self.linear_mode == "onehot_mxu":
            raise NotImplementedError(
                "linear_mode='onehot_mxu' is not ported yet (ROADMAP.md, Queue 1)"
            )
        if self.linear_mode not in ("standard", "lut_gather", "binary_matmul"):
            raise ValueError(f"unknown linear_mode {self.linear_mode!r}")


@dataclasses.dataclass(frozen=True)
class SampleCfg:
    """Sampling options: ``greedy`` (argmax, first maximum on ties),
    ``temperature`` or ``top_k``.  Non-greedy draws are keyed per row by
    an integer key folded with the row's cache position, so a sampled
    stream depends only on (request key, position) and never on the
    admission schedule."""

    mode: str = "greedy"  # greedy | temperature | top_k
    temperature: float = 1.0
    top_k: int = 0


_M32 = 0xFFFFFFFF


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """Integer avalanche hash on int64 tensors holding 32-bit values (every
    product stays below 2**63)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x5BD1E995) & _M32
    return x ^ (x >> 16)


def fold_key(key: torch.Tensor, data) -> torch.Tensor:
    """A new 32-bit key from ``key`` and ``data`` (tensor or int)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    return _hash32(key.to(torch.int64) ^ _hash32(data + 0x9E3779B9))


def sample_tokens(
    logits: torch.Tensor,  # (B, V)
    scfg: SampleCfg,
    keys: torch.Tensor | None = None,  # (B,) int64 per-row keys
) -> torch.Tensor:
    """One token per row under ``scfg``; returns (B,) int32.  Categorical
    draws use the Gumbel-max trick with noise hashed from (key, vocab id),
    so they run on the device with no generator state."""
    if scfg.mode == "greedy":
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if keys is None:
        raise ValueError(f"sampling mode {scfg.mode!r} needs per-row keys")
    scaled = logits.to(torch.float32) / max(scfg.temperature, 1e-6)
    if scfg.mode == "top_k":
        if scfg.top_k <= 0:
            raise ValueError("top_k mode needs SampleCfg.top_k >= 1")
        kth = torch.topk(scaled, scfg.top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    elif scfg.mode != "temperature":
        raise ValueError(f"unknown sampling mode {scfg.mode!r}")
    vocab = torch.arange(scaled.shape[-1], dtype=torch.int64, device=scaled.device)
    bits = fold_key(keys[:, None], vocab[None, :])
    u = ((bits >> 8).to(torch.float32) + 0.5) / float(2**24)
    gumbel = -torch.log(-torch.log(u))
    return torch.argmax(scaled + gumbel, dim=-1).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class Ctx:
    cfg: ModelConfig
    ex: ExecCfg = ExecCfg()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg: ModelConfig, d: int | None = None) -> dict:
    return {"scale": PSpec((d or cfg.d_model,), ("embed",), init="ones")}


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm (the dense family's norm; layernorm comes with whisper)."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# Linear with the TableNet LUT path
# ---------------------------------------------------------------------------


def linear_spec(
    d_in: int, d_out: int, axes=("embed", "heads_flat"), bias: bool = False
) -> dict:
    s = {"w": PSpec((d_in, d_out), axes)}
    if bias:
        s["b"] = PSpec((d_out,), (axes[1],), init="zeros")
    return s


def _host_scales(plan: LUTPlan, scale) -> np.ndarray:
    """Plane scales with a narrow table's dequant scale folded in (both
    powers of two, so the fold is exact), as host fp32 values."""
    s = plane_scales(plan).astype(np.float32)
    if scale is not None:
        s = s * np.float32(float(scale))
    return s


def _lut_apply(
    tables: torch.Tensor,  # (k, entries, p)
    b: torch.Tensor | None,
    plan: LUTPlan,
    x: torch.Tensor,
    ctx: Ctx,
    codes: torch.Tensor | None = None,  # pre-packed (shared across a group)
    scales: np.ndarray | None = None,
    scale=None,  # narrow-table dequant scale
) -> torch.Tensor:
    """One converted projection under the plan stored at conversion time."""
    assert x.shape[-1] == plan.in_features, (x.shape, plan)
    if codes is None:
        codes = pack(x, plan, use_kernels=ctx.ex.use_kernels)
    if scales is None:
        scales = _host_scales(plan, scale)
    y = lut_affine(
        codes,
        tables,
        scales,
        bias=b,
        shift_bits=plan.shift_bits,
        plan=plan,
        use_kernels=ctx.ex.use_kernels,
    )
    return y.to(x.dtype)


def _tl1_apply(
    tables: torch.Tensor,  # (kb, p) uint8 packed base-3 indices
    b: torch.Tensor | None,
    plan: TL1Plan,
    x: torch.Tensor,
    ctx: Ctx,
    acts: tuple | None = None,  # already quantized (codes, act_scale)
    scale: torch.Tensor | None = None,  # ternary weight scale
) -> torch.Tensor:
    """One TL1-converted projection: per-token 9-entry activation LUTs over
    the packed ternary weight-pair indices."""
    assert x.shape[-1] == plan.in_features, (x.shape, plan)
    if acts is None:
        acts = quantize_acts(x, plan)
    codes, act_scale = acts
    y = lut_tl1(
        codes, tables, act_scale, scale, bias=b, plan=plan,
        use_kernels=ctx.ex.use_kernels,
    )
    return y.to(x.dtype)


def _binary_apply(
    w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor, ctx: Ctx
) -> torch.Tensor:
    """The beyond-paper bitplane path of a dense projection: the paper's
    chunk-1 bitplane LUT, a 2-entry table ``{0, w_i}`` being a product with
    a bit, with the adds done by the tensor cores."""
    ex = ctx.ex
    fmt = FixedPointFormat(ex.fixed_bits, ex.fixed_frac, signed=True)
    planes = bitplane_pack(
        x, kind="fixed", m=1, bits=fmt.total_bits, frac=fmt.frac_bits, signed=True,
        use_kernels=ex.use_kernels,
    )  # (..., n, q): at chunk 1 a code is one bit
    y = binary_matmul(planes, w, fmt.plane_scales(), bias=b, use_kernels=ex.use_kernels)
    return y.to(x.dtype)


def linear(p: dict | LUTLinear, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """y = x @ W (+ b), or its TableNet-converted equivalent."""
    if isinstance(p, LUTLinear):
        if isinstance(p.plan, TL1Plan):
            return _tl1_apply(p.tables, p.b, p.plan, x, ctx, scale=p.scale)
        return _lut_apply(p.tables, p.b, p.plan, x, ctx, scale=p.scale)
    b = p.get("b")
    if ctx.ex.linear_mode == "binary_matmul":
        return _binary_apply(p["w"], b, x, ctx)
    y = x @ p["w"]
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _tl1_group_apply(
    node: LUTGroup,
    wanted: list[str],
    x: torch.Tensor,
    ctx: Ctx,
    acts: tuple | None = None,  # already quantized (shared across groups)
):
    """TL1 twin of :func:`_group_apply`: the input is quantized ONCE for the
    group; with every member wanted and ``ctx.ex.lut_grouped`` set, the
    stored ``(G, kb, p)`` leaf feeds one grouped launch.  Ternary scales
    are per member (``node.scale`` is ``(G,)``)."""
    plan = node.plan
    if acts is None:
        acts = quantize_acts(x, plan)
    codes, act_scale = acts
    outs: dict[str, torch.Tensor] = {}
    if len(wanted) == len(node.members) and ctx.ex.lut_grouped:
        stacked_b = node.b if isinstance(node.b, torch.Tensor) else None
        y = lut_tl1_grouped(
            codes, node.tables, act_scale, node.scale, biases=stacked_b, plan=plan,
            use_kernels=ctx.ex.use_kernels,
        )
        for g, name in enumerate(node.members):
            yi = y[g]
            if stacked_b is None and node.member_bias(g) is not None:
                yi = yi + node.member_bias(g)
            outs[name] = yi.to(x.dtype)
        return outs
    for g, name in enumerate(node.members):
        if name in wanted:
            outs[name] = _tl1_apply(
                node.tables[g], node.member_bias(g), plan, x, ctx,
                acts=acts, scale=node.scale[..., g],
            )
    return outs


def _group_apply(
    node: LUTGroup,
    wanted: list[str],
    x: torch.Tensor,
    ctx: Ctx,
    codes: torch.Tensor | None = None,
):
    """Execute (a subset of) a pre-stacked :class:`LUTGroup` against ``x``.

    The input is packed ONCE for the whole group.  When every member is
    wanted and ``ctx.ex.lut_grouped`` is set, the stored ``(G, k, E, p)``
    tensor feeds one grouped launch as it is; otherwise each wanted member
    runs the per-projection path on its ``tables[g]`` view."""
    plan = node.plan
    if codes is None:
        codes = pack(x, plan, use_kernels=ctx.ex.use_kernels)
    scales = _host_scales(plan, node.scale)
    outs: dict[str, torch.Tensor] = {}
    if len(wanted) == len(node.members) and ctx.ex.lut_grouped:
        stacked_b = node.b if isinstance(node.b, torch.Tensor) else None
        y = lut_affine_grouped(
            codes,
            node.tables,
            scales,
            biases=stacked_b,
            shift_bits=plan.shift_bits,
            plan=plan,
            use_kernels=ctx.ex.use_kernels,
        )
        for g, name in enumerate(node.members):
            yi = y[g]
            if stacked_b is None and node.member_bias(g) is not None:
                yi = yi + node.member_bias(g)
            outs[name] = yi.to(x.dtype)
        return outs
    for g, name in enumerate(node.members):
        if name in wanted:
            outs[name] = _lut_apply(
                node.tables[g], node.member_bias(g), plan, x, ctx,
                codes=codes, scales=scales,
            )
    return outs


def fused_linears(
    parent: dict, names: Sequence[str], x: torch.Tensor, ctx: Ctx
) -> list[torch.Tensor]:
    """Apply the sibling projections ``names`` of ``parent`` to the same
    input, returning outputs in ``names`` order.  Pre-stacked groups are
    read in place (:func:`_group_apply`); anything stored per name falls
    back to :func:`linear`, so the result always equals the unfused path."""
    outs: dict[str, torch.Tensor] = {}
    packed: dict[tuple, Any] = {}  # share packed codes across same-input groups
    for node in parent.values():
        if isinstance(node, LUTGroup):
            wanted = [m for m in node.members if m in names]
            if not wanted:
                continue
            p = node.plan
            if isinstance(p, TL1Plan):
                # TL1's packing is the activation quantization: one
                # (codes, act_scale) per input format across groups
                key = ("tl1", p.in_features, p.act_bits)
                if key not in packed:
                    packed[key] = quantize_acts(x, p)
                outs.update(_tl1_group_apply(node, wanted, x, ctx, acts=packed[key]))
                continue
            key = ("weight", p.in_features, p.chunk_size, p.mode, p.fmt)
            if key not in packed:
                packed[key] = pack(x, p, use_kernels=ctx.ex.use_kernels)
            outs.update(_group_apply(node, wanted, x, ctx, codes=packed[key]))
    for name in names:
        if name not in outs:
            outs[name] = linear(parent[name], x, ctx)
    return [outs[name] for name in names]


def member_linear(parent: dict, name: str, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """One projection by name, whether stored per name or inside a group."""
    return fused_linears(parent, (name,), x, ctx)[0]


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) absolute indices."""
    half = x.shape[-1] // 2
    freqs = theta ** (
        -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA over a dense cache)
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    bias = cfg.attn_bias
    return {
        "wq": linear_spec(d, cfg.num_heads * hd, bias=bias),
        "wk": linear_spec(d, cfg.num_kv_heads * hd, bias=bias),
        "wv": linear_spec(d, cfg.num_kv_heads * hd, bias=bias),
        "wo": linear_spec(cfg.num_heads * hd, d, axes=("heads_flat", "embed")),
    }


def _split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, -1)


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask, zero, torch.full_like(zero, -1e9))


def _sdpa(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, K, hd)
    v: torch.Tensor,  # (B, Sk, K, hd)
    mask: torch.Tensor,  # (B, 1, Sq, Sk) bool
) -> torch.Tensor:
    """Grouped scaled-dot-product attention in fp32; returns (B, Sq, H*hd).
    Cached bf16 K/V widen to fp32 exactly, as the reference's promotion."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).to(torch.float32)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k.to(torch.float32))
    scores = scores / math.sqrt(hd) + _mask_bias(mask)[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.to(q.dtype))
    return out.reshape(B, Sq, H * hd)


def causal_mask(
    q_pos: torch.Tensor,  # (B, Sq)
    k_pos: torch.Tensor,  # (B, Sk)
    k_valid: torch.Tensor | None = None,  # (B, Sk) bool
) -> torch.Tensor:
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if k_valid is not None:
        m &= k_valid[:, None, :]
    return m[:, None]  # (B, 1, Sq, Sk)


def attention(
    p: dict,
    x: torch.Tensor,
    ctx: Ctx,
    positions: torch.Tensor,
    cache: dict | None = None,
) -> torch.Tensor:
    """Full-sequence (prefill) or cached-decode attention.

    ``cache`` is one layer's ``{"k", "v"}`` views plus the step's
    ``"_meta"`` :class:`~repro_torch.serve._cache.CacheWrite`; K/V are
    written into those views in place.  Decode attends over the bf16
    cache; a prefill attends over its in-flight fp32 keys."""
    cfg = ctx.cfg
    yq, yk, yv = fused_linears(p, ("wq", "wk", "wv"), x, ctx)
    q = _split_heads(yq, cfg.num_heads)
    k = _split_heads(yk, cfg.num_kv_heads)
    v = _split_heads(yv, cfg.num_kv_heads)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is not None:
        from repro_torch.serve._cache import update_kv_cache

        k_all, v_all, k_pos, k_valid = update_kv_cache(cache, k, v, positions, ctx)
        if x.shape[1] == 1:  # decode: attend over the cached keys
            k, v = k_all, v_all
            mask = causal_mask(positions, k_pos, k_valid)
        else:
            mask = causal_mask(positions, positions)
    else:
        mask = causal_mask(positions, positions)
    return linear(p["wo"], _sdpa(q, k, v, mask), ctx)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act != "silu":
        raise NotImplementedError(f"{cfg.act} MLPs come with their family's slice")
    return {
        "w_gate": linear_spec(d, f, axes=("embed", "mlp")),
        "w_up": linear_spec(d, f, axes=("embed", "mlp")),
        "w_down": linear_spec(f, d, axes=("mlp", "embed")),
    }


def mlp(p: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    g, u = fused_linears(p, ("w_gate", "w_up"), x, ctx)
    return linear(p["w_down"], F.silu(g) * u, ctx)
