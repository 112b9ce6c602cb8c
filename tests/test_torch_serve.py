"""``repro_torch.serve`` against ``repro.serve`` on reduced granite_8b:
greedy ``generate`` and ``BatchingEngine`` streams identical to the JAX
ones (dense, LUT per projection, LUT grouped), the dense cache's write
semantics, admission schedules, EOS, overflow and sampled streams."""
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
from repro.serve import generate as jgenerate
from repro.serve._cache import advance_meta as j_advance_meta
from repro.serve._cache import update_kv_cache as j_update_kv_cache
from repro_torch.configs.base import get_config
from repro_torch.core.convert import convert_params
from repro_torch.core.planner import ModelPlan
from repro_torch.models.layers import Ctx, ExecCfg, SampleCfg
from repro_torch.models.model import model_forward
from repro_torch.models.params import params_from_numpy
from repro_torch.serve import (
    BatchingEngine,
    CacheOverflowError,
    Request,
    advance_meta,
    generate,
    make_cache,
    make_decode_step,
    make_prefill_step,
    update_kv_cache,
)

SERVING = dict(
    max_chunk=2,
    modes=("bitplane", "bitplane_shift"),
    radices=(1, 2, 4),
    table_formats=(None, "i8"),
)
MAX_NEW, MAX_LEN, SLOTS = 8, 32, 3


def _prompts(seed=7, n=5, vocab=512):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(0, vocab, int(rng.integers(3, 14))).astype(np.int32)
        for _ in range(n)
    ]


@pytest.fixture(scope="module")
def world():
    jcfg = jget_config("granite_8b", reduced=True)
    cfg = get_config("granite_8b", reduced=True)
    jp = jinit_params(jmodel_specs(jcfg), jax.random.PRNGKey(5))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    uniform = jplan_model(jp, float("inf"), max_chunk=2)
    jm = jplan_model(jp, uniform.total_lut_bytes // 2, **SERVING)
    mp = ModelPlan.from_json(jm.to_json())
    jlut, _ = jconvert(jp, plan=jm)
    tlut, _ = convert_params(tp, plan=mp)
    tflat, _ = convert_params(tp, plan=mp, group_siblings=False)
    rng = np.random.default_rng(8)
    prompts = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    # the JAX package's streams, computed once
    ref = {}
    for name, params, grouped in (("dense", jp, False), ("lut", jlut, True)):
        jctx = JCtx(jcfg, ex=JExecCfg(remat="none", lut_grouped=grouped))
        ref[name, "generate"] = np.asarray(
            jgenerate(params, jctx, jnp.asarray(prompts), MAX_NEW)
        )
        eng = JEngine(params, jctx, SLOTS, MAX_LEN)
        reqs = [JRequest(i, jnp.asarray(p), MAX_NEW) for i, p in enumerate(_prompts())]
        for r in reqs:
            eng.submit(r)
        ref[name, "engine"] = [r.generated for r in eng.run()]
    return dict(
        cfg=cfg, jcfg=jcfg, tp=tp, tlut=tlut, tflat=tflat, prompts=prompts, ref=ref
    )


SETTINGS = [  # (port params, lut_grouped, reference streams)
    ("tp", False, "dense"),
    ("tflat", False, "lut"),
    ("tlut", True, "lut"),
]


@pytest.mark.parametrize("params,grouped,ref", SETTINGS)
def test_generate_streams_identical_to_reference(world, params, grouped, ref):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    got = generate(world[params], ctx, world["prompts"], MAX_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), world["ref"][ref, "generate"])


@pytest.mark.parametrize("params,grouped,ref", SETTINGS)
@pytest.mark.parametrize("admit", ["batched", "per-slot"])
def test_engine_streams_identical_to_reference(world, params, grouped, ref, admit):
    ctx = Ctx(world["cfg"], ex=ExecCfg(lut_grouped=grouped))
    eng = BatchingEngine(world[params], ctx, SLOTS, MAX_LEN, admit=admit, device="cpu")
    reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    got = [r.generated for r in eng.run()]
    assert got == world["ref"][ref, "engine"]
    assert all(r.done for r in reqs)
    # one readback per admission prefill and per decode step
    steps = MAX_NEW - 1
    assert eng.readbacks >= steps
    assert eng.prefill_tokens == sum(len(p) for p in _prompts())


def test_prefill_then_decode_matches_full_forward(world):
    cfg, params = world["cfg"], world["tlut"]
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, 512, (2, 12)).astype(np.int32))
    full, _, _ = model_forward(params, {"tokens": tokens}, ctx)
    cache = make_cache(cfg, 2, 20, ctx, dtype=torch.float32, device="cpu")
    logits, cache = make_prefill_step(ctx)(params, {"tokens": tokens[:, :8]}, cache)
    got = [logits[:, -1]]
    decode = make_decode_step(ctx)
    for t in range(8, 12):
        _, lg, cache = decode(params, cache, tokens[:, t : t + 1])
        got.append(lg[:, -1])
    want = full[:, 7:12]
    np.testing.assert_allclose(
        torch.stack(got, 1).numpy(),
        want.numpy(),
        rtol=0,
        atol=1e-4 * want.abs().max().item(),
    )


def _cache_pair(world, B, T, index, seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, T, 2, 16)).astype(np.float32)
    pos = rng.integers(0, 50, (B, T)).astype(np.int32)
    valid = rng.random((B, T)) < 0.5
    j = {"pos": jnp.asarray(pos), "valid": jnp.asarray(valid),
         "index": jnp.asarray(index, jnp.int32), "overflow": jnp.zeros((B,), bool)}
    t = {"pos": torch.from_numpy(pos.copy()), "valid": torch.from_numpy(valid.copy()),
         "index": torch.tensor(index, dtype=torch.int32),
         "overflow": torch.zeros(B, dtype=torch.bool)}
    return j, t, k


@pytest.mark.parametrize(
    "index,S,masked",
    [
        ([0, 2, 5], 2, False),
        ([1, 4, 6], 3, True),
        ([0, 3, 0], 6, False),
        ([6, 0, 1], 1, True),
    ],
)
def test_cache_writes_match_reference(world, index, S, masked):
    """Slot writes, masked no-advance, overflow flags and the S == T
    fresh-row fast path, against the reference's one-hot writes."""
    B, T = 3, 6
    jc, tc, kbuf = _cache_pair(world, B, T, index, seed=S)
    rng = np.random.default_rng(10 + S)
    new = rng.standard_normal((B, S, 2, 16)).astype(np.float32)
    positions = (np.asarray(index)[:, None] + np.arange(S)[None, :]).astype(np.int32)
    mask = rng.random((B, S)) < 0.6 if masked else None
    jc, jw = j_advance_meta(jc, jnp.asarray(positions), None,
                            None if mask is None else jnp.asarray(mask))
    tc, tw = advance_meta(tc, torch.from_numpy(positions), None,
                          None if mask is None else torch.from_numpy(mask))
    for key in ("pos", "valid", "index", "overflow"):
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(jc[key]), err_msg=key)
    jctx, ctx = JCtx(world["jcfg"]), Ctx(world["cfg"])
    jlayer = {"k": jnp.asarray(kbuf), "v": jnp.asarray(kbuf), "_meta": jw}
    tlayer = {
        "k": torch.from_numpy(kbuf.copy()), "v": torch.from_numpy(kbuf.copy()),
        "_meta": tw,
    }
    jnew = jnp.asarray(new)
    jout = j_update_kv_cache(jlayer, jnew, jnew, jnp.asarray(positions), jctx)
    tout = update_kv_cache(tlayer, torch.from_numpy(new), torch.from_numpy(new),
                           torch.from_numpy(positions), ctx)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[1]))
    np.testing.assert_array_equal(tlayer["k"].numpy(), np.asarray(jout[0]["k"]))


def test_eos_matches_reference_and_frees_slots(world):
    cfg, params = world["cfg"], world["tlut"]
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    stream = world["ref"]["lut", "engine"][1]
    eos = stream[2]  # a token this request emits
    eng = BatchingEngine(params, ctx, SLOTS, MAX_LEN, eos_id=eos, device="cpu")
    reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)
    eng.run()
    got = reqs[1].generated
    assert got == stream[: stream.index(eos) + 1]
    assert all(r.done for r in reqs) and all(s is None for s in eng.slots)
    g = generate(
        params, ctx, world["prompts"], MAX_NEW, eos_id=eos, device="cpu"
    ).numpy()
    for row in g:
        hits = np.nonzero(row == eos)[0]
        if hits.size:
            assert (row[hits[0]:] == eos).all()


def test_overflow_is_refused_and_flagged(world):
    cfg, params = world["cfg"], world["tp"]
    ctx = Ctx(cfg)
    eng = BatchingEngine(params, ctx, SLOTS, 16, device="cpu")
    with pytest.raises(CacheOverflowError):
        eng.submit(Request(0, np.arange(10, dtype=np.int32), 8))
    with pytest.raises(CacheOverflowError):
        generate(params, ctx, world["prompts"], 8, max_len=12, device="cpu")
    # the packed overflow column is the backstop: a write past T raises
    eng.submit(Request(1, np.arange(4, dtype=np.int32), 4))
    eng._admit()
    eng.cache["index"][0] = 16
    with pytest.raises(CacheOverflowError, match="slots \\[0\\]"):
        eng.step()


def test_sampled_streams_are_schedule_invariant(world):
    cfg, params = world["cfg"], world["tlut"]
    ctx = Ctx(cfg, ex=ExecCfg(lut_grouped=True))
    out = {}
    for sample in (SampleCfg("temperature", 0.9), SampleCfg("top_k", 1.0, 5)):
        for admit, slots in (("batched", SLOTS), ("per-slot", 2)):
            eng = BatchingEngine(params, ctx, slots, MAX_LEN, sample=sample, seed=3,
                                 admit=admit, device="cpu")
            reqs = [Request(i, p, MAX_NEW) for i, p in enumerate(_prompts())]
            for r in reqs:
                eng.submit(r)
            out[sample.mode, admit] = [r.generated for r in eng.run()]
        assert out[sample.mode, "batched"] == out[sample.mode, "per-slot"]
    assert out["temperature", "batched"] != world["ref"]["lut", "engine"]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "top_k"])
def test_serve_lut_twin_streams_do_not_depend_on_admission(sampled, capsys):
    """``repro_torch.examples.serve_lut`` on the CPU: batched and per-slot
    admission serve the same streams, greedy and sampled (top-k 20 at
    temperature 0.8), every request its ``--max-new`` tokens; without
    ``--device cpu`` and without a card it raises."""
    from repro_torch.examples import serve_lut

    flags = ["--requests", "4", "--max-new", "6", "--device", "cpu"]
    if sampled:
        flags += ["--temperature", "0.8", "--top-k", "20"]
    streams = {admit: [r.generated for r in serve_lut.main(flags + ["--admit", admit])
                       ["requests"]]
               for admit in ("batched", "per-slot")}
    assert streams["batched"] == streams["per-slot"]
    assert [len(s) for s in streams["batched"]] == [6] * 4
    out = capsys.readouterr().out
    assert out.count("tok/s, CPU plain versions") == 2 and out.count("req 3:") == 2
    if not torch.cuda.is_available():  # no silent CPU path
        with pytest.raises(RuntimeError, match="cpu"):
            serve_lut.main(["--requests", "1"])
