"""The engine's decode step as a CUDA graph, on the CPU: what makes the
step capturable and what keeps its launch counts.

* Every tensor of the engine's cache keeps its storage from construction
  through admission prefills and decode steps (a replayed graph reads and
  writes fixed addresses), on reduced granite_8b (planned LUT tables,
  grouped) and reduced qwen2_moe_a2_7b (LUT experts), both admit modes,
  greedy and top-k; greedy streams stay identical to the JAX package's.
* ``CacheWrite.index`` holds the pre-write offsets after the in-place
  advance, on the ``S == T`` fresh-row path and on a masked prefill.
* ``kernels/common.py``'s replay counts add exactly what the capture added,
  per replay, driven with a stand-in for the graph.
* ``cuda_graph=True`` on the CPU raises; the CPU runs eagerly.

The graph itself runs on the card only (``tests/test_torch_kernels_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.core.convert import convert_params as jconvert
from repro.core.planner import plan_model as jplan_model
from repro.models.layers import Ctx as JCtx
from repro.models.layers import ExecCfg as JExecCfg
from repro.models.model import model_specs as jmodel_specs
from repro.models.params import init_params as jinit_params
from repro.serve import BatchingEngine as JEngine
from repro.serve import Request as JRequest
from repro_torch.configs.base import get_config
from repro_torch.core.planner import ModelPlan
from repro_torch.kernels.bitplane_pack import ops as pack_ops
from repro_torch.kernels.common import captured_counts, launch_counters, replay_counted
from repro_torch.kernels.lut_affine import ops as lut_ops
from repro_torch.kernels.lut_tl1 import ops as tl1_ops
from repro_torch.models.layers import Ctx, ExecCfg, SampleCfg
from repro_torch.models.model import model_specs
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    Request,
    advance_meta,
    update_kv_cache,
)
from test_torch_moe import numpy_params
from test_torch_moe_serve import _serving_plan

MAX_NEW, MAX_LEN, SLOTS = 6, 32, 3
SAMPLES = {"greedy": SampleCfg(), "top_k": SampleCfg("top_k", 0.9, 5)}


def _prompts(seed=23, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, int(rng.integers(3, 12))).astype(np.int32)
        for _ in range(n)
    ]


def _granite():
    jcfg = jget_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(5))
    uniform = jplan_model(jp, float("inf"), max_chunk=2)
    jm = jplan_model(
        jp, uniform.total_lut_bytes // 2, max_chunk=2,
        modes=("bitplane", "bitplane_shift"), radices=(1, 2, 4), table_formats=(None, "i8"),
    )
    jlut, _ = jconvert(jp, plan=jm)
    return jcfg, get_config("granite_8b", reduced=True), jlut, jm


def _moe():
    jcfg = jget_config("qwen2_moe_a2_7b", reduced=True)
    cfg = get_config("qwen2_moe_a2_7b", reduced=True)
    jp = jax.tree.map(jnp.asarray, numpy_params(model_specs(cfg), 31))
    jm = _serving_plan(jp)
    jlut, _ = jconvert(jp, plan=jm, convert_experts=True)
    return jcfg, cfg, jlut, jm


@pytest.fixture(scope="module")
def worlds():
    """Per model: the port's converted tree, its config, and the JAX
    engine's greedy streams on the same tree and prompts."""
    out = {}
    for name, build in (("dense", _granite), ("moe", _moe)):
        jcfg, cfg, jlut, jm = build()
        jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=True))
        eng = JEngine(jlut, jctx, SLOTS, MAX_LEN)
        reqs = [JRequest(i, jnp.asarray(p), MAX_NEW) for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        tree = jax.tree.map(np.asarray, jlut)
        plan = ModelPlan.from_json(jm.to_json())
        out[name] = dict(
            cfg=cfg,
            params=params_from_numpy(tree, device="cpu", plan=plan),
            ref=[r.generated for r in eng.run()],
            runs={},
        )
    return out


def _storage(cache: dict) -> dict:
    """Every tensor of the cache (nested too) by its key path -> data_ptr."""
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out.update({f"{key}/{k}": v for k, v in _storage(val).items()})
        else:
            out[key] = val.data_ptr()
    return out


def _serve(world, admit, sample):
    """Serve the prompts one engine step at a time, holding every cache
    tensor's storage to the one it was made with; returns the streams."""
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    eng = BatchingEngine(world["params"], ctx, SLOTS, MAX_LEN, sample=SAMPLES[sample],
                         seed=11, admit=admit, device="cpu")
    assert eng.cuda_graph is False
    made = _storage(eng.cache)
    reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    steps = 0
    while eng.step():
        steps += 1
        assert _storage(eng.cache) == made, f"a cache tensor was rebound at step {steps}"
    assert steps >= MAX_NEW - 1 and all(r.done for r in reqs)
    streams = [r.generated for r in reqs]
    world["runs"][admit, sample] = streams
    return streams


@pytest.mark.parametrize("model", ["dense", "moe"])
@pytest.mark.parametrize("admit", ["batched", "per-slot"])
@pytest.mark.parametrize("sample", ["greedy", "top_k"])
def test_engine_keeps_cache_storage(worlds, model, admit, sample):
    """The steps write every cache tensor in place.  Greedy streams equal
    the JAX engine's; top-k streams are the same under both admit modes
    (a draw depends on (seed, uid, position) only) and differ from greedy."""
    world = worlds[model]
    got = _serve(world, admit, sample)
    if sample == "greedy":
        assert got == world["ref"]
        return
    other = "per-slot" if admit == "batched" else "batched"
    want = world["runs"].get((other, sample)) or _serve(world, other, sample)
    assert got == want
    assert got != world["ref"]


def _meta_cache(index, T, seed):
    rng = np.random.default_rng(seed)
    B = len(index)
    return {
        "pos": torch.from_numpy(rng.integers(0, 50, (B, T)).astype(np.int32)),
        "valid": torch.from_numpy(rng.random((B, T)) < 0.5),
        "index": torch.tensor(index, dtype=torch.int32),
        "overflow": torch.zeros(B, dtype=torch.bool),
    }


def test_write_index_is_pre_write_on_the_fresh_row_path():
    """S == T: the advance moves ``index`` in place by T, the write keeps
    the offsets before it, and the K/V write overwrites exactly the rows
    whose pre-write offset was 0 (a row already written is rejected whole
    and flagged)."""
    index, T = [0, 2, 0], 6
    cache = _meta_cache(index, T, seed=1)
    buf = cache["index"]
    positions = torch.arange(T, dtype=torch.int32)[None, :].expand(3, T)
    cache, w = advance_meta(cache, positions, None)
    assert cache["index"] is buf and w.index.data_ptr() != buf.data_ptr()
    assert w.index.tolist() == index
    assert cache["index"].tolist() == [i + T for i in index]
    assert cache["overflow"].tolist() == [False, True, False]
    rng = np.random.default_rng(2)
    old = torch.from_numpy(rng.standard_normal((3, T, 2, 4)).astype(np.float32))
    new = torch.from_numpy(rng.standard_normal((3, T, 2, 4)).astype(np.float32))
    layer = {"k": old.clone(), "v": old.clone(), "_meta": w}
    update_kv_cache(layer, new, new, positions, Ctx(get_config("granite_8b", reduced=True)))
    for name in ("k", "v"):
        torch.testing.assert_close(layer[name][[0, 2]], new[[0, 2]], rtol=0, atol=0)
        torch.testing.assert_close(layer[name][1], old[1], rtol=0, atol=0)


def test_write_index_is_pre_write_on_a_masked_prefill():
    """A masked prefill advances each row by its real tokens, in place; the
    write's ``index`` and ``slots`` still start at the pre-write offsets."""
    index, T, S = [1, 4, 0], 12, 5
    cache = _meta_cache(index, T, seed=3)
    untouched = cache["valid"][1].clone()
    mask = torch.tensor([[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], dtype=torch.bool)
    positions = torch.tensor(index, dtype=torch.int32)[:, None] + torch.arange(S)[None, :]
    cache, w = advance_meta(cache, positions.to(torch.int32), None, mask)
    assert w.index.tolist() == index
    assert w.slots[:, 0].tolist() == index
    assert cache["index"].tolist() == [4, 4, 5]
    assert torch.equal(cache["valid"][1], untouched)


class _StandInGraph:
    """Counts replays; records nothing."""

    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def _counts():
    return [dict(c) for c in launch_counters()]


def test_replays_add_the_captured_launch_counts():
    """A capture's launches come off the counts when it ends; each replay
    adds them back once, and nothing else."""
    start = _counts()

    def record():
        lut_ops.LAUNCHES["lut_affine"] += 3
        lut_ops.LAUNCHES["lut_affine_grouped"] += 2
        lut_ops.TABLE_COPIES["table_operand"] += 1
        tl1_ops.LAUNCHES["lut_tl1"] += 4
        pack_ops.LAUNCHES["bitplane_pack"] += 5
        return "packed"

    out, added = captured_counts(record)
    assert out == "packed" and _counts() == start
    assert sorted((key, n) for _, key, n in added) == [
        ("bitplane_pack", 5), ("lut_affine", 3), ("lut_affine_grouped", 2),
        ("lut_tl1", 4), ("table_operand", 1),
    ]
    graph = _StandInGraph()
    for r in (1, 2, 3):
        replay_counted(graph, added)
        assert graph.replays == r
        want = [dict(c) for c in start]
        want[0]["lut_affine"] += 3 * r
        want[0]["lut_affine_grouped"] += 2 * r
        want[1]["table_operand"] += r
        want[2]["lut_tl1"] += 4 * r
        want[3]["bitplane_pack"] += 5 * r
        assert _counts() == want
    for c, s in zip(launch_counters(), start):
        c.update(s)


def test_a_failed_capture_puts_the_counts_back():
    start = _counts()

    def record():
        pack_ops.LAUNCHES["bitplane_pack"] += 7
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        captured_counts(record)
    assert _counts() == start


def test_cuda_graph_on_the_cpu(worlds):
    """The CPU runs eagerly by default; asking for the graph there raises."""
    world = worlds["dense"]
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=True))
    assert BatchingEngine(world["params"], ctx, SLOTS, MAX_LEN, device="cpu").cuda_graph is False
    with pytest.raises(ValueError, match="cuda_graph=True"):
        BatchingEngine(world["params"], ctx, SLOTS, MAX_LEN, device="cpu", cuda_graph=True)
