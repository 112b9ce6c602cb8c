"""Mamba-2 (SSD) blocks, the zamba2 backbone (counterpart of
``repro/models/ssm.py``).

A prefill runs the chunked SSD algorithm (Dao & Gu 2024, the "minimal
mamba2" form): an intra-chunk quadratic term, each chunk's state, and the
inter-chunk recurrence as a Python loop over chunks, the decay cumsums and
the carry in fp32.  Decode is the O(1) recurrent update.  ``in_proj`` and
``out_proj`` go through :func:`~repro_torch.models.layers.linear`, so a
converted tree runs them on the LUT kernels, each after its own pack.  The
causal conv, the scan, the decode update and the gated RMSNorm are plain
PyTorch, as they are jnp outside any Pallas kernel in the reference: the
SSD recurrence has data-dependent transition weights, so it is not
LUT-convertible.

A layer's cache holds the causal conv's window ``conv`` (B, K - 1,
conv_dim) and the SSD state ``state`` (B, H, P, N).  The reference's
forward carries the window in the activations' dtype, whatever its cache
declares; the port keeps it in an fp32 buffer, which holds any such value
exactly, and casts it to the activations' dtype on read, as the reference
does.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import Ctx, linear, linear_spec
from repro_torch.models.params import PSpec


def mamba_specs(cfg: ModelConfig) -> dict:
    d, din = cfg.d_model, cfg.d_inner
    H, N = cfg.mamba_heads, cfg.ssm_state
    conv_dim = din + 2 * N  # x, B, C share the causal conv (n_groups = 1)
    proj_out = 2 * din + 2 * N + H  # z, xBC, dt
    return {
        "in_proj": linear_spec(d, proj_out, axes=("embed", "heads_flat")),
        "conv_w": PSpec((cfg.conv_kernel, conv_dim), (None, "heads_flat")),
        "conv_b": PSpec((conv_dim,), ("heads_flat",), init="zeros"),
        "A_log": PSpec((H,), (None,), init="zeros"),
        "dt_bias": PSpec((H,), (None,), init="zeros"),
        "D": PSpec((H,), (None,), init="ones"),
        "norm_scale": PSpec((din,), (None,), init="ones"),
        "out_proj": linear_spec(din, d, axes=("heads_flat", "embed")),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular pairwise sums
    L[i, j] = sum_{t=j+1..i} x_t (and -inf above the diagonal)."""
    T = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P)
    dt: torch.Tensor,  # (B, L, H) post-softplus
    A: torch.Tensor,  # (H,) negative
    Bm: torch.Tensor,  # (B, L, N) (n_groups = 1, shared across heads)
    Cm: torch.Tensor,  # (B, L, N)
    chunk: int = 64,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N)
    compute_dtype: torch.dtype = torch.float32,
):
    """Returns (y (B, L, H, P) fp32, final state (B, H, P, N) fp32).  The
    decay cumsums and the state carry stay fp32; ``compute_dtype`` is the
    dtype of the large intra-chunk tensors, whose products are summed in
    fp32 (the reference's ``preferred_element_type``)."""
    B_, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        raise ValueError(f"chunk {chunk} does not divide the length {L}")
    nc = L // chunk
    f32, cd = torch.float32, compute_dtype
    xdt = (x.to(f32) * dt.to(f32)[..., None]).to(cd).reshape(B_, nc, chunk, H, P)
    dA = (dt.to(f32) * A.to(f32)).reshape(B_, nc, chunk, H)
    Bc = Bm.to(cd).reshape(B_, nc, chunk, N)
    Cc = Cm.to(cd).reshape(B_, nc, chunk, N)

    dA_cs = torch.cumsum(dA, dim=2)  # (B, nc, c, H), fp32 always

    # intra-chunk (the diagonal blocks)
    Lmat = torch.exp(_segsum(dA.transpose(-1, -2))).to(cd)  # (B, nc, H, c, c)
    att = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, :, None] * Lmat
    y_diag = torch.einsum("bchij,bcjhp->bcihp", att.to(f32), xdt.to(f32))

    # each chunk's state
    decay_out = torch.exp(dA_cs[:, :, -1:, :] - dA_cs).to(cd)  # (B, nc, c, H)
    states = torch.einsum("bcjn,bcjhp->bchpn", Bc.to(f32),
                          decay_out.to(f32)[..., None] * xdt.to(f32))

    # the inter-chunk recurrence, chunk by chunk: the state entering each
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])  # (B, nc, H)
    s = (torch.zeros((B_, H, P, N), dtype=f32, device=x.device) if init_state is None
         else init_state.to(f32))
    entering = []
    for c in range(nc):
        entering.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    entering = torch.stack(entering, dim=1).to(cd)  # (B, nc, H, P, N)

    decay_in = torch.exp(dA_cs).to(cd)  # (B, nc, c, H)
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc.to(f32), entering.to(f32))
    y_inter = y_inter * decay_in.to(f32)[..., None]

    y = (y_diag + y_inter).reshape(B_, L, H, P)
    return y, s


def ssd_decode_step(
    x: torch.Tensor,  # (B, 1, H, P)
    dt: torch.Tensor,  # (B, 1, H)
    A: torch.Tensor,
    Bm: torch.Tensor,  # (B, 1, N)
    Cm: torch.Tensor,  # (B, 1, N)
    state: torch.Tensor,  # (B, H, P, N) fp32
):
    """One token's recurrent update: returns (y (B, 1, H, P), new state)."""
    f32 = torch.float32
    dA = torch.exp(dt[:, 0].to(f32) * A.to(f32))  # (B, H)
    xdt = x[:, 0].to(f32) * dt[:, 0].to(f32)[..., None]  # (B, H, P)
    new_state = state * dA[:, :, None, None] + torch.einsum(
        "bhp,bn->bhpn", xdt, Bm[:, 0].to(f32)
    )
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0].to(f32), new_state)
    return y[:, None], new_state


def _causal_conv_full(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with taps (K, C)."""
    K, L = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, i:i + L, :] * w[i][None, None, :] for i in range(K))
    return out + b


def mamba_block(p: dict, x: torch.Tensor, ctx: Ctx, cache: Optional[dict] = None):
    """One Mamba-2 mixer over (B, L, d); returns (out (B, L, d), new_cache).
    ``cache`` (one layer's ``{"conv", "state"}``) selects the branch: none
    (a forward without a cache), decode at L = 1 (the O(1) update), or a
    prefill continuing from the cached state (fp32 whatever ``ssd_bf16``
    says, as in the reference).  ``new_cache`` (None without a cache) is
    for the caller to write back."""
    cfg = ctx.cfg
    B, L, _ = x.shape
    din, H, N, P = cfg.d_inner, cfg.mamba_heads, cfg.ssm_state, cfg.mamba_head_dim
    K = cfg.conv_kernel
    f32 = torch.float32

    zxbcdt = linear(p["in_proj"], x, ctx)
    z = zxbcdt[..., :din]
    xBC = zxbcdt[..., din:2 * din + 2 * N]
    dt = F.softplus(zxbcdt[..., 2 * din + 2 * N:].to(f32) + p["dt_bias"])
    A = -torch.exp(p["A_log"].to(f32))

    new_cache = None
    if cache is None:
        xBC = _causal_conv_full(xBC, p["conv_w"], p["conv_b"])
    else:
        window = torch.cat([cache["conv"].to(xBC.dtype), xBC], dim=1)
        new_conv = window[:, -(K - 1):, :]
        xBC = _causal_conv_full(window, p["conv_w"], p["conv_b"])[:, -L:, :]
    xBC = F.silu(xBC)
    xs = xBC[..., :din].reshape(B, L, H, P)
    Bm = xBC[..., din:din + N]
    Cm = xBC[..., din + N:]

    chunk = ctx.ex.ssd_chunk or _pick_chunk(L)
    if cache is None:
        cd = torch.bfloat16 if ctx.ex.ssd_bf16 else f32
        y, _ = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(chunk, L), compute_dtype=cd)
    elif L == 1:  # decode: the O(1) recurrent update
        y, new_state = ssd_decode_step(xs, dt, A, Bm, Cm, cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}
    else:  # prefill continuing from the cached state
        y, new_state = ssd_chunked(xs, dt, A, Bm, Cm, chunk=min(chunk, L),
                                   init_state=cache["state"])
        new_cache = {"conv": new_conv, "state": new_state}

    # D is per head: each head's value repeats over its P channels
    y = y.reshape(B, L, din) + xBC[..., :din] * p["D"].repeat_interleave(P)[None, None, :]
    # the gated RMSNorm (mamba2): norm(y * silu(z))
    g = y.to(f32) * F.silu(z.to(f32))
    ms = g.square().mean(-1, keepdim=True)
    g = (g * torch.rsqrt(ms + cfg.norm_eps) * p["norm_scale"]).to(x.dtype)
    return linear(p["out_proj"], g, ctx), new_cache


def _pick_chunk(L: int) -> int:
    for c in (64, 32, 16, 8, 4, 2, 1):
        if L % c == 0:
            return c
    return 1
