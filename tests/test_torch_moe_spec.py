"""Speculative decoding of a MoE model in the port's engine, against the
JAX reference's engine (reduced granite-moe-1b-a400m: 8 experts, top-2,
served under `kv4_attn8_packed`, page 8, 3 slots, k 3, 3 requests).

A verify pass sizes expert capacity for its k+1 tokens, C = int(cf (k+1)
top_k / E) + 1 (2 here, against the decode step's 1), as the reference's
does, so it drops other assignments than k+1 decode steps and a
speculative run's greedy tokens follow the reference's, not the plain
engine's.  Pinned here:

- the static `w4a4_kv4_attn4` draft, the self-draft and the default
  adaptive ladder each equal the JAX engine's tokens per request, and
  the self-draft's acceptance equals the reference's;
- the self-draft shows the dropped assignments: its acceptance stays
  below 1 (a self-draft of a dense model accepts every draft);
- the report states the decode step's and the verify pass's grouped
  shape, and every engine drains its pages and reservations.

The reference's runs and the port's are each made once (module-scoped
caches); the card's runs are chip_smoke.py's phase 3j.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime import controller as C  # noqa: E402
from repro_torch.serving import spec_decode as TSD  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RE = importlib.import_module("repro.launch.engine")
RC = importlib.import_module("repro.runtime.controller")
RSD = importlib.import_module("repro.serving.spec_decode")

NAME = "granite-moe-1b-a400m"
POLICY = "kv4_attn8_packed"
GEOM = dict(page_size=8, n_pages=32, max_batch=3, max_pages_per_req=6,
            token_budget=16, prefill_chunk=8)
LENS = [(9, 5), (14, 7), (5, 4)]
K = 3
RUNS = ["static", "self", "ladder"]


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
def _ref():
    rcfg = RCFG.reduce_config(RCFG.get_config(NAME)).replace(policy=POLICY)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    return rmodel, rparams


@functools.lru_cache(maxsize=None)
def _port():
    cfg = reduce_config(get_config(NAME)).replace(policy=POLICY)
    model = build_model(cfg, device="cpu")
    return model, convert_params(jax.tree.map(np.asarray, _ref()[1]), model)


def _requests(mod, vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=s0)
                        .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(LENS)]


def _kw(run, spec_mod, ctrl_mod):
    if run == "static":
        return {"spec": spec_mod.SpecConfig("w4a4_kv4_attn4", k=K)}
    if run == "self":
        return {"spec": spec_mod.SpecConfig(POLICY, k=K)}
    return {"adaptive": ctrl_mod.ControllerConfig(
        ctrl_mod.default_ladder(POLICY), k=K)}


def _outputs(engine):
    return {r.rid: list(r.out_tokens) for r in engine.finished}


@functools.lru_cache(maxsize=None)
def _jax_run(run):
    rmodel, rparams = _ref()
    engine = RE.Engine(rmodel, rparams, RE.EngineConfig(**GEOM),
                       **_kw(run, RSD, RC))
    rep = engine.run(_requests(RE, rmodel.cfg.vocab_size))
    return _outputs(engine), rep["acceptance_rate"]


@functools.lru_cache(maxsize=None)
def _port_run(run):
    model, params = _port()
    engine = TE.Engine(model, params, TE.EngineConfig(**GEOM), device="cpu",
                       **_kw(run, TSD, C))
    rep = engine.run(_requests(TE, model.cfg.vocab_size))
    assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
    return _outputs(engine), rep


@pytest.mark.parametrize("run", RUNS)
def test_moe_spec_engine_matches_jax(run):
    got, rep = _port_run(run)
    want, acceptance = _jax_run(run)
    assert got == want
    assert rep["acceptance_rate"] == pytest.approx(acceptance, abs=0)
    assert rep["spec_rounds"] > 0 and rep["n_requests"] == len(LENS)
    assert all(len(got[i]) == g for i, (_, g) in enumerate(LENS))


def test_moe_self_draft_verify_drops_assignments():
    """The verify pass's capacity (2 slots at 4 tokens) drops assignments
    that single-token decode steps keep, so the self-draft rejects some
    of its own drafts, in the reference as here."""
    _, rep = _port_run("self")
    assert 0.0 < rep["acceptance_rate"] < 1.0
    assert rep["acceptance_rate"] == _jax_run("self")[1]


def test_moe_spec_report_states_grouped_shapes():
    _, rep = _port_run("ladder")
    shapes = rep["moe_grouped_shapes"]
    assert shapes["decode"] == {"tokens": 1, "capacity": 1,
                                "rows_per_expert": 3,
                                "route": "torch_f32"}
    assert shapes[f"verify k={K}"] == {"tokens": K + 1, "capacity": 2,
                                       "rows_per_expert": 6,
                                       "route": "torch_f32"}
    text = TE.format_report(rep, POLICY)
    assert f"verify k={K} 6 (capacity 2)" in text
    assert "adaptive: 3-rung ladder" in text



def test_moe_slots_and_per_row_gates():
    """`moe_slots` places each batch row's assignments in (token, slot)
    order, an expert's first C kept and the rest dropped (a naive count
    here), so a row's first token never drops; `by_query_row` over the
    routing's three outputs equals one call (the verify pass's gates)."""
    from repro_torch.core.device import by_query_row
    from repro_torch.models.layers import moe_slots, route_tokens
    rng = np.random.default_rng(5)
    E, C, K = 4, 2, 2
    gate_i = torch.from_numpy(np.stack([np.stack([
        rng.choice(E, K, replace=False) for _ in range(6)])
        for _ in range(3)]))
    order, sorted_e, pos, keep = moe_slots(gate_i, E, C)
    flat = gate_i.reshape(3, -1)
    assert torch.equal(sorted_e, flat.gather(1, order))
    inv = torch.argsort(order, dim=-1)
    for b in range(3):
        seen = [0] * E
        for a, e in enumerate(flat[b].tolist()):
            assert bool(keep[b, inv[b, a]]) == (seen[e] < C)
            assert int(pos[b, inv[b, a]]) == (seen[e] if seen[e] < C else 0)
            seen[e] += 1
    assert bool(keep.gather(1, inv).reshape(3, 6, K)[:, 0].all())
    logits = torch.from_numpy(rng.standard_normal((3, 4, 8)).astype(
        np.float32))
    for got, want in zip(by_query_row(lambda z: route_tokens(z, K), logits),
                         route_tokens(logits, K)):
        assert torch.equal(got, want)
