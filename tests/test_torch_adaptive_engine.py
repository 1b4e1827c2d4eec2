"""The port's adaptive draft ladder in the engine (`Engine(adaptive=...)`),
against the plain engine, the static spec engine and the JAX reference's
adaptive engine (`tests/test_adaptive_engine.py`'s geometry, reduced
qwen3-4b):

- greedy adaptive output equals the plain engine, the static spec engine
  and JAX's adaptive engine token for token, for the serving presets of
  both default-ladder cache layouts;
- also under a controller that switches rung every round, installed
  through the `_ctrl_step` seam (more than one rung drafts);
- a one-rung ladder is static drafting (same tokens, same acceptance);
- reservations hold tick by tick across forced switches with per-rung
  draft lengths, priced at the ladder's max k;
- the submit guard prices the ladder's max k;
- the global acceptance rate is the drafted-token-weighted aggregate of
  the rungs', and the rung wall shares sum to 1;
- sampled adaptive runs repeat and drain;
- a MoE model is served adaptively, as the reference serves it.
"""
import dataclasses
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime import controller as C  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RE = importlib.import_module("repro.launch.engine")
RC = importlib.import_module("repro.runtime.controller")

GEOM = dict(page_size=8, n_pages=32, max_batch=3, max_pages_per_req=6,
            token_budget=16, prefill_chunk=8)
ECFG = TE.EngineConfig(**GEOM)
LENS = [(9, 5), (14, 7), (5, 4)]
K = 3
SAMPLED = SamplerConfig(temperature=0.8, top_k=16, top_p=0.95, seed=7)
PRESETS = ["kv4_attn8_packed", "kv8_attn_f32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops lose
    most of their time to thread hand-offs when test workers share the
    cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _np_params():
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b"))
    rparams = RMODELS.build_model(rcfg.replace(policy=PRESETS[0])).init(
        jax.random.PRNGKey(0))
    return rcfg, rparams, jax.tree.map(np.asarray, rparams)


@functools.lru_cache(maxsize=None)
def _model(preset):
    cfg = reduce_config(get_config("qwen3-4b")).replace(policy=preset)
    model = build_model(cfg, device="cpu")
    return model, convert_params(_np_params()[2], model)


def _requests(mod, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, 256, size=s0)
                        .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(LENS)]


def _run(engine, check=None):
    for r in _requests(TE):
        engine.submit(r)
    now = 0.0
    while engine.waiting or any(engine.slots):
        engine.step(now)
        now += 0.01
        if check is not None:
            check(engine)
    return {r.rid: list(r.out_tokens) for r in engine.finished}


def _engine(preset, **kw):
    model, params = _model(preset)
    return TE.Engine(model, params, ECFG, device="cpu", **kw)


def _adaptive_cfg(mod, preset, **kw):
    kw.setdefault("k", K)
    kw.setdefault("start", 0)
    kw.setdefault("dwell", 1)
    return mod.ControllerConfig(mod.default_ladder(preset), **kw)


def _every_round_cycler(cfg, state, accepted, drafted):
    nxt = (state.rung + 1) % len(cfg.ladder)
    return dataclasses.replace(state, rung=nxt,
                               switches=state.switches + 1), nxt


@functools.lru_cache(maxsize=None)
def _plain(preset):
    return _run(_engine(preset))


@functools.lru_cache(maxsize=None)
def _jax_adaptive(preset):
    rcfg, rparams, _ = _np_params()
    engine = RE.Engine(RMODELS.build_model(rcfg.replace(policy=preset)),
                       rparams, RE.EngineConfig(**GEOM),
                       adaptive=_adaptive_cfg(RC, preset))
    engine.run(_requests(RE))
    return {r.rid: list(r.out_tokens) for r in engine.finished}


def _check_alloc_invariants(engine):
    alloc = engine.alloc
    live = [r for r in engine.slots if r is not None]
    assert alloc.in_use == sum(len(r.pages) for r in live)
    assert alloc.reserved == sum(r.reserved_left for r in live)
    assert alloc.reserved <= alloc.n_free
    assert alloc.in_use + alloc.n_free == alloc.capacity - 1
    for r in live:
        row = engine._table[r.slot]
        if r.state == TE.DECODE:
            assert list(row[:len(r.pages)]) == r.pages
            assert np.all(row[len(r.pages):] == TKV.SCRATCH_PAGE)
        else:
            assert np.all(row == TKV.SCRATCH_PAGE)


@pytest.mark.parametrize("preset", PRESETS)
def test_greedy_adaptive_matches_plain_static_and_jax(preset):
    acfg = _adaptive_cfg(C, preset)
    engine = _engine(preset, adaptive=acfg)
    got = _run(engine)
    assert got == _plain(preset)
    assert got == _jax_adaptive(preset)
    assert engine.spec_rounds > 0
    static = _run(_engine(preset, spec=SpecConfig(acfg.ladder[0], K)))
    assert static == _plain(preset)
    text = TE.format_report(engine.report(1.0), preset)
    assert "adaptive: 3-rung ladder" in text and "rung 2: " in text


@pytest.mark.parametrize("preset", PRESETS)
def test_greedy_adaptive_every_round_switch(preset):
    engine = _engine(preset, adaptive=_adaptive_cfg(C, preset))
    engine._ctrl_step = _every_round_cycler
    assert _run(engine) == _plain(preset)
    assert engine.ctrl_switches > 0
    assert sum(1 for n in engine.rung_rounds if n > 0) > 1


def test_one_rung_ladder_equals_static_spec():
    preset, draft = PRESETS[0], "w4a4_kv4_attn4"
    static = _engine(preset, spec=SpecConfig(draft, K))
    want = _run(static)
    srep = static.report(1.0)
    one = _engine(preset, adaptive=C.ControllerConfig((draft,), k=K))
    assert _run(one) == want
    rep = one.report(1.0)
    assert rep["acceptance_rate"] == srep["acceptance_rate"]
    assert rep["adaptive_switches"] == 0
    assert rep["adaptive_rungs"][0]["acceptance_rate"] == \
        srep["acceptance_rate"]


def test_reservation_accounting_across_forced_switches():
    acfg = C.ControllerConfig(C.default_ladder(PRESETS[0]), ks=(3, 1, 2))
    engine = _engine(PRESETS[0], adaptive=acfg)
    engine._ctrl_step = _every_round_cycler
    assert engine._spec_k == 3
    got = _run(engine, check=_check_alloc_invariants)
    assert engine.ctrl_switches > 0
    assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
    assert got == _plain(PRESETS[0])


def test_submit_guard_prices_ladder_max_k():
    acfg = C.ControllerConfig(C.default_ladder(PRESETS[0]), ks=(1, 1, 9))
    engine = _engine(PRESETS[0], adaptive=acfg)
    # s_max = 48; 30 + 10 + max_k(9) = 49 > 48, though the start rung's
    # k = 1 would fit
    with pytest.raises(ValueError, match="draft window"):
        engine.submit(TE.Request(rid=0, prompt=np.zeros(30, np.int32),
                                 max_new=10))


def test_acceptance_rate_is_rung_weighted_aggregate():
    engine = _engine(PRESETS[0], adaptive=_adaptive_cfg(C, PRESETS[0]))
    engine._ctrl_step = _every_round_cycler
    _run(engine)
    rep = engine.report(1.0)
    rungs = rep["adaptive_rungs"]
    drafted = sum(r["drafted"] for r in rungs)
    accepted = sum(r["accepted"] for r in rungs)
    assert drafted == engine.drafted and accepted == engine.drafts_accepted
    assert rep["acceptance_rate"] == pytest.approx(accepted / drafted)
    agg = sum(r["acceptance_rate"] * r["drafted"] for r in rungs) / drafted
    assert rep["acceptance_rate"] == pytest.approx(agg)
    assert rep["adaptive_switches"] == engine.ctrl_switches > 0
    assert sum(r["rounds"] for r in rungs) == rep["spec_rounds"]
    assert rep["draft_steps"] == sum(r["rounds"] * r["k"] for r in rungs)
    ws = [r["wall_share"] for r in rungs if r["rounds"] > 0]
    assert sum(ws) == pytest.approx(1.0)


def test_sampled_adaptive_deterministic_and_drains():
    runs = []
    for _ in range(2):
        engine = _engine(PRESETS[0], sampler=SAMPLED,
                         adaptive=_adaptive_cfg(C, PRESETS[0]))
        runs.append(_run(engine))
        assert len(engine.finished) == len(LENS)
        assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
        assert all(len(t) == g for (_, g), t in
                   zip(LENS, [runs[-1][i] for i in range(len(LENS))]))
    assert runs[0] == runs[1]


def test_moe_speculation_refused_naming_its_item():
    """A MoE model speculates as the reference's engine does: the
    adaptive ladder is served (the refusal and its ROADMAP item are gone),
    drains, and the report states the verify pass's grouped shape beside
    the decode step's (`tests/test_torch_moe_spec.py` holds the tokens to
    the JAX engine's)."""
    assert not hasattr(TE, "MOE_SPEC_ITEM")
    cfg = reduce_config(get_config("granite-moe-1b-a400m")).replace(
        policy=PRESETS[0])
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    engine = TE.Engine(model, params, ECFG, device="cpu",
                       adaptive=_adaptive_cfg(C, PRESETS[0]))
    got = _run(engine)
    assert sorted(got) == list(range(len(LENS)))
    assert all(len(got[i]) == g for i, (_, g) in enumerate(LENS))
    assert engine.spec_rounds > 0
    assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
    shapes = engine.report(1.0)["moe_grouped_shapes"]
    assert shapes["decode"]["capacity"] == 1
    assert shapes[f"verify k={K}"]["capacity"] == TE.moe_capacity(cfg, K + 1)
