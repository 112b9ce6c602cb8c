"""RWKV-6 ("Finch") blocks: attention-free, data-dependent per-channel decay
(counterpart of ``repro/models/rwkv.py``).

Prefill runs the chunked parallel form of the WKV linear recurrence
(GLA-style: an intra-chunk quadratic term with cumulative log-decay
weights and an inter-chunk state carry), in fp32, as a Python loop over
chunk views; decode is the O(1) recurrent update.  The r/k/v/g/o and
channel-mix projections go through :func:`~repro_torch.models.layers.linear`,
so a converted tree runs them on the LUT kernels, each after its own pack
(every projection reads a differently mixed input, so none fuse).  The
decay LoRA, the scan and the decode step are plain PyTorch, as they are
jnp outside any Pallas kernel in the reference.

The decode cache holds no ring: per layer the token-shift states
``shift_a`` (time mix) and ``shift_c`` (channel mix), (B, d) each, the
WKV state ``wkv`` (B, H, K, V), and ``index`` (B,).  ``forward`` writes
them in place.  The reference declares the shift states in the cache's
dtype, but its forward returns them in the activations' dtype, so its
carry is in that dtype after the first write; the port's buffers are
fp32, which hold that carry exactly, and ``_token_shift`` casts it to the
activations' dtype on read, as the reference's does.  While autograd
records (training), each layer (time and channel mix) runs under the
``ExecCfg.remat`` policy (``transformer.remat``), as the reference
checkpoints its scan body.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.layers import Ctx, linear, linear_spec
from repro_torch.models.params import PSpec


def rwkv_specs(cfg: ModelConfig) -> dict:
    d, H, hd = cfg.d_model, cfg.rwkv_heads, cfg.rwkv_head_dim
    r = cfg.decay_lora_rank

    def mix():
        return PSpec((d,), (None,), init="zeros")

    return {
        "time": {
            "mu_r": mix(),
            "mu_k": mix(),
            "mu_v": mix(),
            "mu_w": mix(),
            "mu_g": mix(),
            "w_r": linear_spec(d, d),
            "w_k": linear_spec(d, d),
            "w_v": linear_spec(d, d),
            "w_g": linear_spec(d, d),
            "w_o": linear_spec(d, d, axes=("heads_flat", "embed")),
            "decay_base": PSpec((d,), (None,), init="zeros"),
            "decay_A": PSpec((d, r), ("embed", None), scale=0.01),
            "decay_B": PSpec((r, d), (None, "heads_flat"), scale=0.01),
            "u": PSpec((H, hd), ("heads", None), init="zeros"),
            "ln_scale": PSpec((d,), (None,), init="ones"),
            "ln_bias": PSpec((d,), (None,), init="zeros"),
        },
        "channel": {
            "mu_k": mix(),
            "mu_r": mix(),
            "w_k": linear_spec(d, cfg.d_ff, axes=("embed", "mlp")),
            "w_v": linear_spec(cfg.d_ff, d, axes=("mlp", "embed")),
            "w_r": linear_spec(d, d),
        },
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]) -> torch.Tensor:
    """(B, L, d) -> previous token's features (zeros / cache for t=0)."""
    prev = torch.zeros_like(x[:, :1]) if last is None else last[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def wkv_chunked(
    r: torch.Tensor,  # (B, L, H, K)
    k: torch.Tensor,  # (B, L, H, K)
    v: torch.Tensor,  # (B, L, H, V)
    logw: torch.Tensor,  # (B, L, H, K)  log decay, < 0
    u: torch.Tensor,  # (H, K) bonus for the current token
    chunk: int = 32,
    init_state: Optional[torch.Tensor] = None,  # (B, H, K, V) fp32
):
    """y_t = r_t @ (S_t + diag(u) k_t v_t^T);  S_{t+1} = diag(w_t) S_t + k_t v_t^T
    (with S_t the state *before* absorbing token t). fp32 inside; returns
    (y (B, L, H, V), final state (B, H, K, V))."""
    B, Lq, H, K = r.shape
    V = v.shape[-1]
    if Lq % chunk:
        raise ValueError(f"chunk {chunk} does not divide the length {Lq}")
    nc = Lq // chunk
    f32 = torch.float32
    rc = r.to(f32).reshape(B, nc, chunk, H, K)
    kc = k.to(f32).reshape(B, nc, chunk, H, K)
    vc = v.to(f32).reshape(B, nc, chunk, H, V)
    lw = logw.to(f32).reshape(B, nc, chunk, H, K)
    uf = u.to(f32)
    idx = torch.arange(chunk, device=r.device)
    tri = (idx[:, None] > idx[None, :]).to(f32)  # strict lower
    s = (torch.zeros((B, H, K, V), dtype=f32, device=r.device) if init_state is None
         else init_state.to(f32))
    ys = []
    for c in range(nc):
        rch, kch, vch, lwch = rc[:, c], kc[:, c], vc[:, c], lw[:, c]  # (B, c, H, {K, V})
        cum = torch.cumsum(lwch, dim=1)  # sum_{t<=i}
        cum_in = cum - lwch  # sum_{t<i}
        # intra-chunk: att[i,j] = sum_k r_ik k_jk exp(cum_in_i - cum_j), j < i;
        # the exponents are differences formed BEFORE exp (<= 0 on the masked
        # triangle), so strong decay cannot overflow them
        expo = cum_in[:, :, None] - cum[:, None, :]  # (B, c, c, H, K)
        w_ij = torch.exp(torch.clamp(expo, max=0.0)) * tri[None, :, :, None, None]
        att = torch.einsum("bihk,bjhk,bijhk->bhij", rch, kch, w_ij)
        bonus = torch.einsum("bihk,hk,bihk->bhi", rch, uf, kch)
        y = torch.einsum("bhij,bjhv->bihv", att, vch)
        y = y + bonus.transpose(1, 2)[..., None] * vch
        # inter-chunk: the contribution of the state entering this chunk
        y = y + torch.einsum("bihk,bhkv->bihv", rch * torch.exp(cum_in), s)
        # carry: S_end = diag(prod w) S_start + sum_j diag(prod_{t>j} w) k_j v_j
        decay_rest = torch.exp(cum[:, -1:] - cum)  # (B, c, H, K), <= 1
        s = s * torch.exp(cum[:, -1])[..., None] + torch.einsum(
            "bjhk,bjhv->bhkv", kch * decay_rest, vch
        )
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, Lq, H, V), s


def wkv_decode_step(r, k, v, logw, u, state):
    """Single token: r/k/v/logw (B, 1, H, K|V); state (B, H, K, V) fp32."""
    f32 = torch.float32
    r1, k1, v1, w1 = (t[:, 0].to(f32) for t in (r, k, v, logw))
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1, state + u.to(f32)[None, :, :, None] * kv)
    new_state = state * torch.exp(w1)[..., None] + kv
    return y[:, None], new_state


def _group_norm(x: torch.Tensor, H: int, scale, bias, eps) -> torch.Tensor:
    """Per-head layernorm over the head dim of (B, L, d=H*hd)."""
    B, Lq, d = x.shape
    xh = x.to(torch.float32).reshape(B, Lq, H, d // H)
    mu = xh.mean(-1, keepdim=True)
    var = xh.var(-1, correction=0, keepdim=True)
    y = ((xh - mu) * torch.rsqrt(var + eps)).reshape(B, Lq, d)
    return y * scale + bias


def rwkv_time_mix(
    p: dict,
    x: torch.Tensor,
    ctx: Ctx,
    last: Optional[torch.Tensor],
    wkv_state: Optional[torch.Tensor],
):
    """Returns (out, new_last, new_wkv_state)."""
    cfg = ctx.cfg
    B, Lq, d = x.shape
    H, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    xx = _token_shift(x, last)

    def mixed(mu):
        return x + (xx - x) * mu[None, None, :]

    r = linear(p["w_r"], mixed(p["mu_r"]), ctx).reshape(B, Lq, H, hd)
    k = linear(p["w_k"], mixed(p["mu_k"]), ctx).reshape(B, Lq, H, hd)
    v = linear(p["w_v"], mixed(p["mu_v"]), ctx).reshape(B, Lq, H, hd)
    g = linear(p["w_g"], mixed(p["mu_g"]), ctx)
    # Finch data-dependent decay: w = exp(-exp(base + LoRA(x_w)))
    dlora = (mixed(p["mu_w"]) @ p["decay_A"]) @ p["decay_B"]
    logw = -torch.exp(
        torch.clamp(p["decay_base"][None, None, :] + dlora.to(torch.float32), -8.0, 4.0)
    ).reshape(B, Lq, H, hd)

    if wkv_state is None:
        y, new_state = wkv_chunked(r, k, v, logw, p["u"], chunk=_pick_chunk(Lq))
    elif Lq == 1:  # decode: O(1) recurrent update
        y, new_state = wkv_decode_step(r, k, v, logw, p["u"], wkv_state)
    else:  # prefill continuing from the cached state
        y, new_state = wkv_chunked(
            r, k, v, logw, p["u"], chunk=_pick_chunk(Lq), init_state=wkv_state
        )
    y = y.reshape(B, Lq, d).to(x.dtype)
    y = _group_norm(y, H, p["ln_scale"], p["ln_bias"], cfg.norm_eps).to(x.dtype)
    out = linear(p["w_o"], y * F.silu(g), ctx)
    return out, x[:, -1], new_state


def rwkv_channel_mix(p: dict, x: torch.Tensor, ctx: Ctx, last: Optional[torch.Tensor]):
    """Returns (out, new_last)."""
    xx = _token_shift(x, last)
    xk = x + (xx - x) * p["mu_k"][None, None, :]
    xr = x + (xx - x) * p["mu_r"][None, None, :]
    h = torch.square(F.relu(linear(p["w_k"], xk, ctx)))
    out = torch.sigmoid(linear(p["w_r"], xr, ctx)) * linear(p["w_v"], h, ctx)
    return out, x[:, -1]


def _pick_chunk(Lq: int) -> int:
    for c in (32, 16, 8, 4, 2, 1):
        if Lq % c == 0:
            return c
    return 1


# ---------------------------------------------------------------------------
# RWKV LM (model-level assembly)
# ---------------------------------------------------------------------------


def rwkv_lm_specs(cfg: ModelConfig) -> dict:
    from repro_torch.models.transformer import stack_specs

    d = cfg.d_model
    specs = rwkv_specs(cfg)
    block = {
        "ln1": L.norm_spec(cfg),
        "time": specs["time"],
        "ln2": L.norm_spec(cfg),
        "channel": specs["channel"],
    }
    return {
        "embed": PSpec((cfg.padded_vocab, d), ("vocab", "embed"), init="embed"),
        "ln0": L.norm_spec(cfg),  # rwkv: extra norm after embedding
        "blocks": stack_specs(block, cfg.num_layers),
        "ln_f": L.norm_spec(cfg),
        "lm_head": L.linear_spec(d, cfg.padded_vocab, axes=("embed", "vocab")),
    }


def _layer_apply(lp, x, ctx: Ctx, shift_a, shift_c, wkv):
    """One RWKV-6 layer: time mix then channel mix, each after its norm ->
    (x, (new shift_a, new shift_c, new wkv state))."""
    cfg = ctx.cfg
    h, new_a, new_w = rwkv_time_mix(lp["time"], L.apply_norm(lp["ln1"], x, cfg), ctx,
                                    shift_a, wkv)
    x = x + h
    h, new_c = rwkv_channel_mix(lp["channel"], L.apply_norm(lp["ln2"], x, cfg), ctx, shift_c)
    return x + h, (new_a, new_c, new_w)


def forward(params, tokens, ctx: Ctx, positions=None, cache=None, embeds=None):
    """Returns ``(logits, cache, aux)``; ``cache`` ({"layers": {shift_a,
    shift_c, wkv}, "index"}: O(1) state, no pos/valid ring) is updated in
    place and ``index`` advances by S.  ``embeds`` is accepted and ignored,
    as in the reference, and ``positions`` is read for its width only."""
    from repro_torch.models.transformer import embed_tokens, lm_logits, remat, unbind_layers
    from repro_torch.serve._cache import advance_meta

    cfg = ctx.cfg
    x = embed_tokens(params, tokens)
    x = L.apply_norm(params["ln0"], x, cfg)
    layer = remat(_layer_apply, ctx, cache)
    for i, lp in enumerate(unbind_layers(params["blocks"], cfg.num_layers)):
        lc = {name: buf[i] for name, buf in cache["layers"].items()} if cache else {}
        x, (new_a, new_c, new_w) = layer(lp, x, ctx, lc.get("shift_a"), lc.get("shift_c"),
                                         lc.get("wkv"))
        if lc:  # in place, into the fp32 buffers
            for name, new in (("shift_a", new_a), ("shift_c", new_c), ("wkv", new_w)):
                lc[name].copy_(new)
    x = L.apply_norm(params["ln_f"], x, cfg)
    if ctx.ex.logits == "last":
        x = x[:, -1:]
    logits = lm_logits(params, x, ctx)
    if cache is not None:
        if positions is None:
            steps = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
            positions = cache["index"][:, None] + steps[None, :]
        advance_meta(cache, positions, None)  # no pos/valid: index += S
    return logits, cache, torch.zeros((), dtype=torch.float32, device=x.device)
