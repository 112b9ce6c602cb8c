"""Serving engine: a device-resident batched scheduler over slot caches
(counterpart of the dense half of ``repro/serve/_engine.py``).

Pass converted params (``core.convert.convert_params``, ideally planned by
``core.planner.plan_model``) and every converted projection runs on the
Hopper kernels; ``ExecCfg(lut_grouped=True)`` fuses each pre-stacked group
into one grouped launch.  The scheduler is agnostic to all of it.

``BatchingEngine`` keeps the reference's contracts:

* Per-slot state (``slot_active`` / ``slot_remaining`` / ``slot_key`` /
  ``next_tok`` / ``overflow``) lives in the cache, on the device; the
  cache is updated in place by both steps.
* Sampling runs on the device; non-greedy draws are keyed by
  ``fold(slot_key, index)`` with ``slot_key = fold(seed, uid)``, so a
  sampled stream depends only on (seed, uid, position) and is the same
  under batched and per-slot admission.
* Admission right-pads up to ``num_slots`` queued prompts into one masked
  prefill that writes each prompt into its slot (``admit="per-slot"``
  admits one request per prefill instead).
* Each step returns a packed (B, 3) int32 ``[token, done, overflow]``
  that the host reads back once (``readbacks`` counts them); an overflow
  flag raises :class:`CacheOverflowError`.
* On a CUDA device the decode step is captured once as a CUDA graph and
  replayed (the counterpart of the reference's ``jax.jit`` with a donated
  cache): its shapes (``num_slots`` x 1 token) and sampling mode are fixed
  per engine, and both steps write the cache in place.  Admission prefill
  and :func:`generate` stay eager.  The kernels' launch counts are kept
  per replay (``kernels/common.py::replay_counted``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.common import captured_counts, replay_counted
from repro_torch.models.layers import Ctx, SampleCfg, fold_key, sample_tokens
from repro_torch.models.model import model_forward
from repro_torch.models.params import init_params
from repro_torch.serve._cache import CacheOverflowError, cache_specs

_ENGINE_FAMILIES = ("dense", "moe")


def make_cache(
    cfg: ModelConfig,
    batch: int,
    max_len: int,
    ctx: Ctx | None = None,
    dtype: torch.dtype = torch.bfloat16,
    page_size: int | None = None,
    device: str | torch.device = "cuda",
) -> dict:
    """A fresh zeroed dense cache on ``device`` (K/V in ``dtype``)."""
    specs = cache_specs(cfg, batch, max_len, page_size=page_size)
    return init_params(specs, torch.Generator(), device=device, default_dtype=dtype)


def _slot_keys(cache: dict) -> torch.Tensor:
    """Per-slot sampling keys at the current write offsets (B,) int64."""
    return fold_key(cache["slot_key"], cache["index"])


def make_prefill_step(ctx: Ctx) -> Callable:
    """(params, inputs, cache) -> (last-token logits, filled cache)."""

    def prefill(params, inputs, cache):
        logits, cache, _ = model_forward(params, inputs, ctx, cache=cache)
        return logits[:, -1:], cache

    return prefill


def make_decode_step(ctx: Ctx, sample: SampleCfg | None = None) -> Callable:
    """(params, cache, tokens (B,1)) -> (next tokens (B,1), logits, cache)."""
    scfg = sample or SampleCfg()

    def decode(params, cache, tokens):
        logits, cache, _ = model_forward(params, {"tokens": tokens}, ctx, cache=cache)
        keys = _slot_keys(cache) if scfg.mode != "greedy" else None
        return sample_tokens(logits[:, -1], scfg, keys)[:, None], logits, cache

    return decode


@torch.no_grad()
def generate(
    params,
    ctx: Ctx,
    prompts,
    max_new: int,
    max_len: int | None = None,
    eos_id: Optional[int] = None,
    sample: SampleCfg | None = None,
    seed: int = 0,
    page_size: int | None = None,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Reference generation loop, aligned with :class:`BatchingEngine`:
    each row stops at its first ``eos_id`` (emitted), later positions are
    padded with ``eos_id``; raises :class:`CacheOverflowError` up front when
    ``prompt + max_new - 1`` writes cannot fit in ``max_len``."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, dtype=torch.int32).to(dev)
    B, S = prompts.shape
    scfg = sample or SampleCfg()
    T = max_len or (S + max_new)
    if S + max_new - 1 > T:
        raise CacheOverflowError(
            f"prompt ({S} tokens) + max_new ({max_new}) needs "
            f"{S + max_new - 1} cache slots but max_len is {T}; raise max_len"
        )
    cache = make_cache(ctx.cfg, B, T, ctx, page_size=page_size, device=dev)
    if scfg.mode != "greedy":
        base = torch.tensor(seed, dtype=torch.int64, device=dev)
        cache["slot_key"] = fold_key(base, torch.arange(B, device=dev))
    prefill, decode = make_prefill_step(ctx), make_decode_step(ctx, scfg)
    logits, cache = prefill(params, {"tokens": prompts}, cache)
    keys = _slot_keys(cache) if scfg.mode != "greedy" else None
    tok = sample_tokens(logits[:, -1], scfg, keys)[:, None]
    out = [tok]
    done = np.zeros((B,), bool)
    for _ in range(max_new - 1):
        if eos_id is not None:
            done = done | (tok[:, 0].cpu().numpy() == eos_id)
            if done.all():
                break
        tok, _, cache = decode(params, cache, tok)
        if eos_id is not None:
            tok = torch.where(torch.as_tensor(done, device=dev)[:, None], eos_id, tok)
        out.append(tok)
    toks = torch.cat(out, dim=1)
    if toks.shape[1] < max_new:  # every row hit EOS early: pad the rectangle
        pad = torch.full_like(toks[:, :1], eos_id).expand(B, max_new - toks.shape[1])
        toks = torch.cat([toks, pad], dim=1)
    return toks


# ---------------------------------------------------------------------------
# Device-resident batched scheduler
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    uid: int
    prompt: Any  # (S,) int32
    max_new: int
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def _engine_steps(ctx: Ctx, scfg: SampleCfg, eos_id: Optional[int]):
    """The engine's two steps, each writing the cache in place (into the
    buffers the engine allocated, so that a captured decode step's replay
    sees what the steps wrote):

    prefill: (params, cache, tokens, lens, admit, uids, max_news, base_key)
             -> packed
    decode:  (params, cache) -> packed

    with packed (B, 3) int32 = [sampled token, done, overflow].  Logits are
    kept for every position: the batched prefill reads each slot's logits
    at its own last real token."""
    sctx = dataclasses.replace(ctx, ex=dataclasses.replace(ctx.ex, logits="all"))

    def _sample(last, cache):
        keys = _slot_keys(cache) if scfg.mode != "greedy" else None
        return sample_tokens(last, scfg, keys)

    def _packed(tok, done, cache):
        return torch.stack(
            [tok, done.to(torch.int32), cache["overflow"].to(torch.int32)], dim=1
        )

    def _eos(tok):
        if eos_id is None:
            return torch.zeros_like(tok, dtype=torch.bool)
        return tok == eos_id

    @torch.no_grad()
    def prefill(params, cache, tokens, lens, admit, uids, max_news, base_key):
        adm1 = admit[:, None]
        cache["index"].masked_fill_(admit, 0)
        cache["pos"].masked_fill_(adm1, 0)
        cache["valid"] &= ~adm1
        cache["overflow"] &= ~admit
        fresh_keys = fold_key(base_key, uids)
        cache["slot_key"].copy_(torch.where(admit, fresh_keys, cache["slot_key"]))
        remaining = max_news - 1
        cache["slot_remaining"].copy_(
            torch.where(admit, remaining, cache["slot_remaining"])
        )
        S = tokens.shape[1]
        steps = torch.arange(S, dtype=torch.int32, device=tokens.device)[None, :]
        mask = (steps < lens[:, None]) & adm1
        logits, cache, _ = model_forward(
            params, {"tokens": tokens, "token_mask": mask}, sctx, cache=cache
        )
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        last = logits[rows, torch.clamp(lens - 1, min=0).to(torch.int64)]
        tok = _sample(last, cache)
        done = admit & (_eos(tok) | (cache["slot_remaining"] <= 0))
        cache["slot_active"].copy_((cache["slot_active"] | admit) & ~done)
        cache["next_tok"].copy_(torch.where(adm1, tok[:, None], cache["next_tok"]))
        return _packed(tok, done, cache)

    @torch.no_grad()
    def decode(params, cache):
        active = cache["slot_active"].clone()  # read after the in-place update below
        logits, cache, _ = model_forward(
            params,
            {"tokens": cache["next_tok"], "token_mask": active[:, None]},
            sctx,
            cache=cache,
        )
        tok = _sample(logits[:, -1], cache)
        remaining = cache["slot_remaining"] - active.to(torch.int32)
        done = active & (_eos(tok) | (remaining <= 0))
        cache["slot_remaining"].copy_(remaining)
        cache["slot_active"].copy_(active & ~done)
        act1 = active[:, None]
        cache["next_tok"].copy_(torch.where(act1, tok[:, None], cache["next_tok"]))
        return _packed(tok, done, cache)

    return prefill, decode


def _bucket(n: int, cap: int) -> int:
    """Right-pad prompts to a power-of-two bucket."""
    b = 4
    while b < n:
        b *= 2
    return min(b, cap)


class BatchingEngine:
    """Fixed-slot continuous batching, device-resident: finished sequences
    are swapped for queued requests between decode steps by batched masked
    prefill (see the module docstring for the contracts).

    ``cuda_graph`` (default: on for a CUDA device, off on the CPU, where
    ``True`` raises) runs the decode step as replays of one captured CUDA
    graph; ``False`` keeps the eager step."""

    def __init__(
        self,
        params,
        ctx: Ctx,
        num_slots: int,
        max_len: int,
        eos_id: Optional[int] = None,
        sample: SampleCfg | None = None,
        seed: int = 0,
        admit: str = "batched",
        prefill_bucket: int | None = None,
        page_size: int | None = None,
        device: str | torch.device = "cuda",
        cuda_graph: bool | None = None,
    ):
        if ctx.cfg.family not in _ENGINE_FAMILIES:
            raise NotImplementedError(
                f"BatchingEngine serves {_ENGINE_FAMILIES} so far, "
                f"not {ctx.cfg.family!r}"
            )
        if admit not in ("batched", "per-slot"):
            raise ValueError(f"admit must be 'batched' or 'per-slot': {admit!r}")
        if page_size is not None:
            raise NotImplementedError("paged serving comes with the paging slice")
        self.device = resolve_device(device)
        if cuda_graph is None:
            cuda_graph = self.device.type == "cuda"
        elif cuda_graph and self.device.type != "cuda":
            raise ValueError(f"cuda_graph=True needs a CUDA device, not {self.device}")
        self.cuda_graph = cuda_graph
        self._graph = None  # (CUDAGraph, its packed output, the counts a replay adds)
        self._warmed_up = False
        self.params, self.ctx = params, ctx
        self.num_slots, self.max_len = num_slots, max_len
        self.eos_id = eos_id
        self.sample = sample or SampleCfg()
        self.admit_mode = admit
        self.queue: list[Request] = []
        self.slots: list[Optional[Request]] = [None] * num_slots
        self.cache = make_cache(ctx.cfg, num_slots, max_len, ctx, device=self.device)
        self._T = self.cache["pos"].shape[1]
        self.prefill_bucket = prefill_bucket
        if prefill_bucket is not None and prefill_bucket > self._T:
            raise ValueError(
                f"prefill_bucket {prefill_bucket} exceeds cache capacity {self._T}"
            )
        dev = self.device
        self.cache.update(
            overflow=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
            slot_active=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
            slot_remaining=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
            slot_key=torch.zeros((num_slots,), dtype=torch.int64, device=dev),
            next_tok=torch.zeros((num_slots, 1), dtype=torch.int32, device=dev),
        )
        self._base_key = torch.tensor(seed, dtype=torch.int64, device=dev)
        self._prefill, self._decode = _engine_steps(ctx, self.sample, eos_id)
        self.readbacks = 0  # host syncs: 1/decode step + 1/admission prefill
        self.prefill_tokens = 0

    def submit(self, req: Request):
        plen = int(len(req.prompt))
        if plen < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        cap = self.prefill_bucket or self._T
        if plen > cap:
            raise ValueError(
                f"request {req.uid}: prompt ({plen}) exceeds the prefill "
                f"capacity ({cap} tokens)"
            )
        if plen + req.max_new - 1 > self.max_len:
            raise CacheOverflowError(
                f"request {req.uid}: prompt ({plen}) + max_new ({req.max_new}) "
                f"needs {plen + req.max_new - 1} cache slots but max_len is "
                f"{self.max_len}; overflowing writes would drop tokens"
            )
        self.queue.append(req)

    def _check(self, packed: torch.Tensor) -> np.ndarray:
        """The ONE host readback per step; backstop overflow check."""
        arr = packed.cpu().numpy()
        self.readbacks += 1
        if arr[:, 2].any():
            raise CacheOverflowError(
                f"cache overflow flagged for slots {arr[:, 2].nonzero()[0].tolist()}"
            )
        return arr

    def _admit(self):
        while self.queue and any(s is None for s in self.slots):
            free = [i for i, s in enumerate(self.slots) if s is None]
            limit = 1 if self.admit_mode == "per-slot" else len(free)
            placed: list[tuple[Request, int]] = []
            while self.queue and len(placed) < limit:
                req = self.queue.pop(0)
                if req.max_new <= 0:
                    req.done = True  # nothing requested; don't pay a prefill
                    continue
                placed.append((req, free[len(placed)]))
            if not placed:
                return
            B = self.num_slots
            prompts = [np.asarray(r.prompt, np.int32) for r, _ in placed]
            S = self.prefill_bucket or _bucket(max(len(t) for t in prompts), self._T)
            tokens = np.zeros((B, S), np.int32)
            lens = np.ones((B,), np.int32)
            admit = np.zeros((B,), bool)
            uids = np.zeros((B,), np.int64)
            max_news = np.ones((B,), np.int32)
            for (req, s), prompt in zip(placed, prompts):
                tokens[s, : len(prompt)] = prompt
                lens[s], admit[s] = len(prompt), True
                uids[s], max_news[s] = req.uid, req.max_new
            dev = self.device
            packed = self._prefill(
                self.params,
                self.cache,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(lens).to(dev),
                torch.from_numpy(admit).to(dev),
                torch.from_numpy(uids).to(dev),
                torch.from_numpy(max_news).to(dev),
                self._base_key,
            )
            self.prefill_tokens += int(sum(len(t) for t in prompts))
            arr = self._check(packed)
            for req, s in placed:
                req.generated.append(int(arr[s, 0]))
                if arr[s, 1]:  # EOS at prefill or max_new == 1: free the slot
                    req.done = True
                else:
                    self.slots[s] = req

    def _decode_step(self) -> torch.Tensor:
        """The decode step, eager; or under ``cuda_graph`` eager the first
        time (which also warms up every kernel's build, attributes and
        tensor maps, and the allocator), captured into the engine's own
        graph and memory pool the second time, then replayed.  A capture
        that fails raises: the step never falls back to eager."""
        if not self.cuda_graph or not self._warmed_up:
            self._warmed_up = True
            return self._decode(self.params, self.cache)
        if self._graph is None:
            graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(self.device)

            def record():
                # the outer context restores the engine's stream also when
                # the capture fails (a failed end of capture skips the inner)
                with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
                    return self._decode(self.params, self.cache)

            try:
                packed, added = captured_counts(record)
            except Exception as e:
                raise RuntimeError(
                    f"capturing the decode step as a CUDA graph failed: {e}"
                ) from e
            self._graph = graph, packed, added
        graph, packed, added = self._graph
        replay_counted(graph, added)
        return packed

    def step(self) -> bool:
        """One decode step over all active slots; returns True if any active."""
        self._admit()
        if all(r is None for r in self.slots):
            return False
        arr = self._check(self._decode_step())
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            req.generated.append(int(arr[s, 0]))
            if arr[s, 1]:
                req.done = True
                self.slots[s] = None
        return True

    def run(self) -> list[Request]:
        all_reqs = list(self.queue)
        while self.step():
            pass
        return all_reqs
