"""Shared model layers (counterpart of ``repro/models/layers.py``): norms
(RMSNorm and LayerNorm), RoPE and sinusoidal positions, linears with the
TableNet LUT path, GQA attention (self-attention over a dense or paged KV
cache, and cross-attention over given K/V) and MLA latent attention, the
gated, squared-ReLU and GELU MLPs and sampling.

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
from repro_torch.dist.sharding import ShardCtx
from repro_torch.kernels.binary_matmul.ops import binary_matmul
from repro_torch.kernels.bitplane_pack.ops import bitplane_pack, pack
from repro_torch.kernels.common import device_scales
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
    in fp32.  Converted projections take their LUT path in every mode;
    under ``"onehot_mxu"`` that path's plain version is a matrix product
    (:func:`_onehot_apply`: a one-hot of each code against the tables
    rounded to bf16, summed in fp32) on every plan but ``bitplane_shift``,
    and a group fuses only on a ``bitplane_shift`` plan.  ``use_kernels``
    runs the projections on the Hopper kernels when their inputs lie on the
    card (False asks for the plain PyTorch versions);
    ``lut_grouped`` fuses a pre-stacked group's projections into one
    grouped launch; ``logits="last"`` keeps only the final position's
    head.  ``remat`` is every family's layer-body activation checkpointing
    while gradients are recorded (training): ``"full"`` keeps only each body's
    input and recomputes the rest in the backward pass, ``"dots"`` also
    keeps every matmul's output, ``"dots_no_batch"`` those of the products
    without a batch dimension (the projections, not attention's), and
    ``"none"`` keeps everything; without gradients it changes nothing.
    ``ssd_chunk`` is the Mamba-2 SSD scan's chunk (0: the largest of
    64, 32, ..., 1 dividing the length) and ``ssd_bf16`` runs its large
    intra-chunk tensors in bf16 on a prefill without a cache (the decay
    cumsums and the carry stay fp32), as the reference's knobs."""

    linear_mode: str = "standard"  # standard | lut_gather | onehot_mxu | binary_matmul
    fixed_bits: int = 8  # binary_matmul input format
    fixed_frac: int = 6
    lut_grouped: bool = False
    use_kernels: bool = True
    logits: str = "all"  # all | last
    ssd_chunk: int = 0  # 0 = auto
    ssd_bf16: bool = False
    remat: str = "full"  # full | dots | dots_no_batch | none

    def __post_init__(self):
        if self.remat not in ("full", "dots", "dots_no_batch", "none"):
            raise ValueError(f"unknown remat policy {self.remat!r}")
        if self.linear_mode not in ("standard", "lut_gather", "onehot_mxu", "binary_matmul"):
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
    # the mesh and its rules (``dist/sharding.py``); inert without a mesh
    shard: ShardCtx = ShardCtx()


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_spec(cfg: ModelConfig, d: int | None = None) -> dict:
    d = d or cfg.d_model
    s = {"scale": PSpec((d,), ("embed",), init="ones")}
    if cfg.norm == "layernorm":
        s["bias"] = PSpec((d,), ("embed",), init="zeros")
    return s


def apply_norm(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``cfg.norm`` in fp32: RMSNorm, or LayerNorm (whisper) with the biased
    variance, as ``jnp.var`` computes it, and a bias."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * p["scale"] + p["bias"]
        return y.to(x.dtype)
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


# the largest fp32 one-hot block :func:`_onehot_apply` builds at once
_ONEHOT_BYTES = 1 << 30


def _onehot_apply(
    tables: torch.Tensor,  # (k, E, p)
    b: torch.Tensor | None,
    codes: torch.Tensor,  # (..., n, k) indices below E
    scales: np.ndarray,  # (n,) host fp32
) -> torch.Tensor:
    """``linear_mode="onehot_mxu"``'s LUT apply, the reference's
    ``einsum("...nke,kep->...np", one_hot(codes, E), bf16(tables))`` with
    fp32 accumulation, then the plane scales and the bias, in fp32.

    A one-hot entry times a bf16 value is exact in fp32 (and in TF32, whose
    10-bit mantissa holds bf16's 8 bits), so the product runs in fp32 on
    the tables rounded to bf16: the sums are the reference's up to fp32
    summation order.  The (rows x n, k x E) one-hot is built in row blocks
    of at most ``_ONEHOT_BYTES``; the last block is padded to the others'
    rows, so every block of a call is one product of one shape (a BLAS may
    pick its reduction order by the shape: cuBLAS does, so on the card a
    call that needs blocks agrees with one product to fp32 summation order,
    where the CPU's agrees bit for bit).  A code outside ``[0, E)`` selects
    nothing, as ``jax.nn.one_hot``'s zero row."""
    *lead, n, k = codes.shape
    k2, E, p = tables.shape
    if k != k2:
        raise ValueError(f"codes have {k} chunks, tables {k2}")
    flat = codes.reshape(-1, n * k)
    R = flat.shape[0]
    t = tables.to(torch.bfloat16).to(torch.float32).reshape(k * E, p)
    entries = torch.arange(E, dtype=flat.dtype, device=flat.device)
    rows = max(1, min(R, _ONEHOT_BYTES // (n * k * E * 4)))
    per_plane = torch.empty((R, n, p), dtype=torch.float32, device=tables.device)
    for r0 in range(0, R, rows):
        blk = flat[r0:r0 + rows]
        if blk.shape[0] < rows:  # one shape for every block's product
            blk = torch.cat([blk, blk.new_full((rows - blk.shape[0], n * k), E)])
        onehot = (blk[..., None] == entries).reshape(rows * n, k * E)
        out = (onehot.to(torch.float32) @ t).reshape(rows, n, p)
        per_plane[r0:r0 + rows] = out[: min(rows, R - r0)]
    y = torch.einsum("rnp,n->rp", per_plane, device_scales(scales, tables.device))
    if b is not None:
        y = y + b.to(torch.float32)
    return y.reshape(*lead, p)


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
    if ctx.ex.linear_mode == "onehot_mxu" and not ctx.ex.use_kernels and not plan.shift_bits:
        # bitplane_shift codes carry an exponent above the index bits, so
        # they cannot feed a one-hot of width num_entries: those gather
        return _onehot_apply(tables, b, codes, scales).to(x.dtype)
    y = lut_affine(
        codes,
        tables,
        scales,
        bias=b,
        shift_bits=plan.shift_bits,
        plan=plan,
        blocks=plan.blocks,
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
        codes, tables, act_scale, scale, bias=b, plan=plan, blocks=plan.blocks,
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
    w = p["w"]
    if x.dtype != w.dtype:  # mixed operands promote, as jnp's matmul does
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
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
            blocks=plan.blocks, use_kernels=ctx.ex.use_kernels,
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
    runs the per-projection path on its ``tables[g]`` view.  Under
    ``onehot_mxu`` a group fuses only on a ``bitplane_shift`` plan, whose
    members gather in every mode, as in the reference."""
    plan = node.plan
    if codes is None:
        codes = pack(x, plan, use_kernels=ctx.ex.use_kernels)
    scales = _host_scales(plan, node.scale)
    outs: dict[str, torch.Tensor] = {}
    fuse = (
        len(wanted) == len(node.members)
        and ctx.ex.lut_grouped
        and (ctx.ex.linear_mode != "onehot_mxu" or plan.shift_bits != 0)
    )
    if fuse:
        stacked_b = node.b if isinstance(node.b, torch.Tensor) else None
        y = lut_affine_grouped(
            codes,
            node.tables,
            scales,
            biases=stacked_b,
            shift_bits=plan.shift_bits,
            plan=plan,
            blocks=plan.blocks,
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


def sinusoidal_embedding(S: int, d: int, device=None) -> torch.Tensor:
    """(S, d) fp32 sinusoidal positions ``[sin, cos]`` at 0..S-1."""
    return sinusoidal_at(torch.arange(S, device=device), d)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """fp32 ``[sin, cos]`` of ``positions`` (any shape) over ``d // 2``
    frequencies ``10000 ** (-2i / d)``: shape ``positions.shape + (d,)``."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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
    window: int | None = None,
) -> torch.Tensor:
    m = q_pos[:, :, None] >= k_pos[:, None, :]
    if window is not None:
        m &= q_pos[:, :, None] - k_pos[:, None, :] < window
    if k_valid is not None:
        m &= k_valid[:, None, :]
    return m[:, None]  # (B, 1, Sq, Sk)


def attention(
    p: dict,
    x: torch.Tensor,
    ctx: Ctx,
    positions: torch.Tensor,
    cache: dict | None = None,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Full-sequence (prefill) or cached-decode attention.

    ``cache`` is one layer's ``{"k", "v"}`` views plus the step's
    ``"_meta"`` :class:`~repro_torch.serve._cache.CacheWrite`; K/V are
    written into those views in place.  Decode attends over the bf16
    cache; a dense prefill attends over its in-flight fp32 keys.  A paged
    prefill attends through the page-table view, as decode does: prefix
    sharing maps pages written earlier into the slot, so the in-flight
    keys are not the whole visible context (the causal mask and ``valid``
    exclude what is not written yet).  A sliding-window model's paged
    prefill attends over its in-flight keys, as a dense one does: its ring
    keeps only the last ``window`` keys, which is state for decode, not a
    view for the early queries, and its engine shares no prefixes.  Every
    branch masks keys ``window`` or more positions back.

    With ``cross_kv`` (the enc-dec decoder's cross-attention) the keys and
    values are given, (B, S_enc, K, hd): only ``wq`` runs, through
    :func:`member_linear` (a group member alone), nothing is written to a
    cache, and every query sees every key."""
    cfg = ctx.cfg
    window = cfg.sliding_window
    if cross_kv is not None:
        q = _split_heads(member_linear(p, "wq", x, ctx), cfg.num_heads)
        k, v = cross_kv
        if cfg.pos == "rope":
            q = rope(q, positions, cfg.rope_theta)
        B, S = x.shape[:2]
        mask = torch.ones((B, 1, S, k.shape[1]), dtype=torch.bool, device=x.device)
        return linear(p["wo"], _sdpa(q, k, v, mask), ctx)
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
        paged_prefill = cache["_meta"].page_ids is not None and window is None
        if x.shape[1] == 1 or paged_prefill:
            k, v = k_all, v_all
            mask = causal_mask(positions, k_pos, k_valid, window)
        else:
            mask = causal_mask(positions, positions, None, window)
    else:
        mask = causal_mask(positions, positions, None, window)
    return linear(p["wo"], _sdpa(q, k, v, mask), ctx)


# ---------------------------------------------------------------------------
# MLA attention (minicpm3: latent KV)
# ---------------------------------------------------------------------------

# The up-projections MLA reads as raw weights in its absorbed form: veto them
# in the planner and the converter (``mla_convertible`` as their
# ``predicate``), so that they stay fp32 latent products, as the reference
# computes them in jnp outside any Pallas kernel.
MLA_RAW_WEIGHTS = ("wk_b", "wv_b")


def mla_convertible(path: tuple, node) -> bool:
    """The planner's and converter's ``predicate`` for an MLA tree."""
    return path[-1] not in MLA_RAW_WEIGHTS


def mla_specs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    nope, rdim, vdim = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    H = cfg.num_heads
    return {
        "wq_a": linear_spec(d, cfg.q_lora_rank, axes=("embed", None)),
        "q_norm": {"scale": PSpec((cfg.q_lora_rank,), (None,), init="ones")},
        "wq_b": linear_spec(cfg.q_lora_rank, H * (nope + rdim), axes=(None, "heads_flat")),
        "wkv_a": linear_spec(d, cfg.kv_lora_rank + rdim, axes=("embed", None)),
        "kv_norm": {"scale": PSpec((cfg.kv_lora_rank,), (None,), init="ones")},
        "wk_b": linear_spec(cfg.kv_lora_rank, H * nope, axes=(None, "heads_flat")),
        "wv_b": linear_spec(cfg.kv_lora_rank, H * vdim, axes=(None, "heads_flat")),
        "wo": linear_spec(H * vdim, d, axes=("heads_flat", "embed")),
    }


def _raw_weight(p: dict, name: str) -> torch.Tensor:
    node = p.get(name)
    if not isinstance(node, dict):
        raise ValueError(
            f"MLA reads {name} as a raw weight (the absorbed form), but the tree holds "
            f"{type(node).__name__ if node is not None else 'no such node'} there: plan "
            f"and convert an MLA tree with predicate=mla_convertible, which vetoes "
            f"{MLA_RAW_WEIGHTS}"
        )
    return node["w"]


def _latent_sdpa(
    q_nope: torch.Tensor,  # (B, Sq, H, nope)
    q_rope: torch.Tensor,  # (B, Sq, H, rope_dim), rotated
    c_kv: torch.Tensor,  # (B, Sk, kv_lora)
    k_rope: torch.Tensor,  # (B, Sk, rope_dim), rotated, shared by every head
    mask: torch.Tensor,  # (B, 1, Sq, Sk) bool
    wk_b: torch.Tensor,  # (kv_lora, H * nope)
    wv_b: torch.Tensor,  # (kv_lora, H * v_dim)
) -> torch.Tensor:
    """MLA's absorbed attention in fp32; returns (B, Sq, H * v_dim).
    ``q_nope`` is projected into the latent space through ``wk_b``, the
    scores take ``1/sqrt(nope + rope_dim)``, and the attended latents go
    out through ``wv_b``: two fp32 latent products, as the reference's
    einsums.  Cached bf16 latents widen to fp32 exactly, as the reference's
    promotion."""
    B, S, H, nope = q_nope.shape
    r = c_kv.shape[-1]
    q_lat = torch.einsum("bshn,lhn->bshl", q_nope, wk_b.reshape(r, H, nope))
    scores = (
        torch.einsum("bshl,btl->bhst", q_lat.to(torch.float32), c_kv.to(torch.float32))
        + torch.einsum("bshr,btr->bhst", q_rope.to(torch.float32), k_rope.to(torch.float32))
    ) / math.sqrt(nope + q_rope.shape[-1])
    probs = torch.softmax(scores + _mask_bias(mask), dim=-1).to(q_nope.dtype)
    ctx_lat = torch.einsum("bhst,btl->bshl", probs, c_kv.to(probs.dtype))
    out = torch.einsum("bshl,lhv->bshv", ctx_lat, wv_b.reshape(r, H, -1))
    return out.reshape(B, S, -1)


def mla_attention(
    p: dict,
    x: torch.Tensor,
    ctx: Ctx,
    positions: torch.Tensor,
    cache: dict | None = None,
) -> torch.Tensor:
    """Multi-head latent attention in the reference's absorbed form
    (:func:`_latent_sdpa`): the cache holds the normed latent ``c_kv`` (B,
    T, kv_lora) and one rotated ``k_rope`` (B, T, rope_dim) shared by every
    head.

    ``cache`` is one layer's ``{"c_kv", "k_rope"}`` views plus the step's
    ``"_meta"``, written in place.  As in :func:`attention`, decode and a
    paged prefill attend over the (bf16) cache, widened to fp32 as the
    reference's einsums promote it; a dense prefill attends over its fp32
    in-flight latents.  ``wq_a``, ``wq_b``, ``wkv_a`` and ``wo`` go through
    :func:`linear` (the LUT kernels when converted)."""
    cfg = ctx.cfg
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rdim, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q_lat_in = apply_norm(p["q_norm"], linear(p["wq_a"], x, ctx), cfg)
    q = linear(p["wq_b"], q_lat_in, ctx).reshape(B, S, H, nope + rdim)
    q_nope, q_rope = q[..., :nope], rope(q[..., nope:], positions, cfg.rope_theta)
    kv = linear(p["wkv_a"], x, ctx)
    c_kv = apply_norm(p["kv_norm"], kv[..., :r], cfg)
    k_rope = rope(kv[..., r:][:, :, None, :], positions, cfg.rope_theta)[:, :, 0]

    if cache is not None:
        from repro_torch.serve._cache import update_mla_cache

        c_all, r_all, k_pos, k_valid = update_mla_cache(cache, c_kv, k_rope, positions, ctx)
        if S == 1 or cache["_meta"].page_ids is not None:
            c_kv, k_rope = c_all, r_all
            mask = causal_mask(positions, k_pos, k_valid)
        else:
            mask = causal_mask(positions, positions)
    else:
        mask = causal_mask(positions, positions)

    out = _latent_sdpa(q_nope, q_rope, c_kv, k_rope, mask, _raw_weight(p, "wk_b"),
                       _raw_weight(p, "wv_b"))
    return linear(p["wo"], out, ctx)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """The gated SwiGLU MLP (``act="silu"``: ``w_gate``, ``w_up``,
    ``w_down``) or a two-matrix MLP, ``w_in`` and ``w_out``: nemotron's
    squared ReLU (``act="relu2"``, no bias) or whisper's GELU (``act="gelu"``,
    both biased), with the reference's names and axes."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("gelu", "relu2"):
        bias = cfg.act == "gelu"
        return {
            "w_in": linear_spec(d, f, axes=("embed", "mlp"), bias=bias),
            "w_out": linear_spec(f, d, axes=("mlp", "embed"), bias=bias),
        }
    if cfg.act != "silu":
        raise ValueError(f"unknown MLP activation {cfg.act!r}")
    return {
        "w_gate": linear_spec(d, f, axes=("embed", "mlp")),
        "w_up": linear_spec(d, f, axes=("embed", "mlp")),
        "w_down": linear_spec(f, d, axes=("mlp", "embed")),
    }


def mlp(p: dict, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """``w_down(silu(w_gate x) * w_up x)``, or for a two-matrix tree
    ``w_out(relu(w_in x)**2)`` (``relu2``) or ``w_out(gelu(w_in x))``, the
    tanh form that ``jax.nn.gelu`` computes by default; every projection
    through :func:`linear` / :func:`fused_linears`, so each linear kind runs
    here."""
    if "w_in" in p:
        h = linear(p["w_in"], x, ctx)
        if ctx.cfg.act == "relu2":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return linear(p["w_out"], h, ctx)
    g, u = fused_linears(p, ("w_gate", "w_up"), x, ctx)
    return linear(p["w_down"], F.silu(g) * u, ctx)
