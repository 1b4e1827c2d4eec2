"""Tensor-parallel serving in the port (`distributed/tp.py`, the sharded
routes, `Engine(tp=)`, `serve --tp`, `flash_decode`), on gloo ranks of
the CPU spawned by `launch.mesh.run_ranks` (a file store under tmp_path,
a timeout per run).  Each world size is spawned once per module; the
ranks' bodies are in `tests/torch_tp_ranks.py`.

- The reduced qwen3-4b engine at tp 2 and 4 (page 8) serves the tokens
  of the port's tp=1 engine and of the JAX reference's `Engine` (tp=1,
  under `jax.jit`) token for token under `attn_fp16_dpa`,
  `kv8_attn_f32` and `kv4_attn8_packed` (the policies of
  `tests/test_tp_engine.py`), through prefix hits with their CoW copies
  and through `SpecConfig("w4a4_kv4_attn4", k=2)`, on the sharded routes;
  every rank's tokens are equal.
- The fallbacks: page_size % tp != 0 and tp above the group's ranks
  serve replicated, with their reasons, and tp=1's tokens.
- The pool: tokens and prefill rows written at every offset across the
  shard boundaries into each rank's slice, all-gathered
  (`tp._gather_pool`), equal the whole pool byte for byte.
- `flash_decode` over sequence-sharded raw caches at tp 2 and 4 against
  teacher forcing within 3e-4 (`tests/test_perf_features.py:95-138`);
  where S does not divide the group the caches stay whole and decode on
  the plain path.
- The sharded routes' `bytes_moved`: the single-device body's plus the
  reference's pool wire term (`_tp_wire_bytes`) at the same context.
- `launch.serve.main(["--engine", "--tp", "2", "--dist-backend", "gloo"])`
  is in `tests/test_torch_serve.py`.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RE = importlib.import_module("repro.launch.engine")
RSD = importlib.import_module("repro.serving.spec_decode")
RREG = importlib.import_module("repro.kernels.registry")
RPOL = importlib.import_module("repro.core.policy")

RANK_TIMEOUT = 240          # seconds a spawned world may take
FLASH_TOL = 3e-4            # tests/test_perf_features.py's pin


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _base():
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(
        policy=R.PREFIX_POLICY)
    rparams = RMODELS.build_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, jax.tree.map(np.asarray, rparams), rparams


def _jax_run(kind, policy, geom):
    rcfg, _, rparams = _base()
    rmodel = RMODELS.build_model(rcfg.replace(policy=policy))
    spec = RSD.SpecConfig(R.SPEC_DRAFT, k=2) if kind == "spec" else None
    eng = RE.Engine(rmodel, rparams, RE.EngineConfig(**geom), spec=spec)
    reqs = R.workload(RE, kind, rcfg.vocab_size)
    if kind == "prefix":
        for req in reqs:
            eng.run([req])
    else:
        eng.run(reqs)
    return R.tokens_of(eng)


RUNS = {p: ("plain", p, R.GEOM) for p in R.POLICIES}
RUNS["prefix"] = ("prefix", R.PREFIX_POLICY, R.PREFIX_GEOM)
RUNS["spec"] = ("spec", R.PREFIX_POLICY, R.SPEC_GEOM)


@pytest.fixture(scope="module")
def tp1():
    """The port's tp=1 runs and the JAX reference's, by run name."""
    np_params = _base()[1]
    port = {name: R.port_run(*run[:2], np_params, run[2])
            for name, run in RUNS.items()}
    port["indivisible"] = R.port_run("plain", R.PREFIX_POLICY, np_params,
                                     R.INDIVISIBLE_GEOM)
    ref = {name: _jax_run(*run) for name, run in RUNS.items()}
    return port, ref


def _spawn(fn, n, tmp_path_factory, *args):
    store = tmp_path_factory.mktemp(f"tp{n}") / "store"
    return run_ranks(fn, n, backend="gloo", device="cpu",
                     timeout=RANK_TIMEOUT, args=args,
                     init_method=f"file://{store}", threads=1)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every rank body at 2 and 4 ranks, one spawn per world size and
    suite: {n: {"engine": [...], "pool": [...], "flash": [...]}}."""
    np_params = _base()[1]
    out = {}
    for n in (2, 4):
        out[n] = {"engine": _spawn(R.engine_suite, n, tmp_path_factory,
                                   np_params),
                  "pool": _spawn(R.pool_suite, n, tmp_path_factory),
                  "flash": _spawn(R.flash_suite, n, tmp_path_factory)}
    return out


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(RUNS))
def test_tp_engine_equals_tp1_and_reference(worlds, tp1, name, n):
    port, ref = tp1
    assert port[name][0] == ref[name], (name, "port tp=1 vs JAX")
    ranks = worlds[n]["engine"]
    for rank, res in enumerate(ranks):
        toks, rep = res[name]
        assert toks == port[name][0], (name, n, rank)
        assert rep["tp"] == n and "tp_fallback_reason" not in rep, rep
        assert rep["decode_route"] == "paged_decode_sharded", rep
    rep = ranks[0][name][1]
    if name == "spec":
        assert rep["verify_route"] == "verify_attn_sharded", rep
        assert rep["draft_route"] == "paged_decode_sharded", rep
    if name == "prefix":
        want = port["prefix"][1]
        assert rep["prefix_hits"] == want["prefix_hits"] > 0, rep
        assert rep["prefix_cow_copies"] == want["prefix_cow_copies"] > 0
    # the wire: (n-1)/n of every layer's pool, codes + scales, as the
    # reference's route prices it; the rank holds 1/n of the pool
    _, pol_name, geom = RUNS[name]
    cfg = _base()[0]
    ctx = dict(n_devices=n, n_pages=geom["n_pages"],
               page_size=geom["page_size"], kv_heads=cfg.n_kv_heads,
               hd=cfg.hd)
    assert rep["tp_wire_bytes_per_step_layer"] == RREG._tp_wire_bytes(
        RPOL.get_policy(pol_name), ctx) > 0
    assert rep["pool_bytes_allocated_per_device"] * (n - 1) == \
        rep["tp_wire_bytes_per_step_layer"] * cfg.n_layers
    assert rep["tp_wire_staged_through_host"] is False      # CPU tensors


@pytest.mark.parametrize("case,reason", [("indivisible", "not divisible"),
                                         ("too_wide", "exceeds")])
def test_tp_fallbacks_replicate_with_reason(worlds, tp1, case, reason):
    port, _ = tp1
    want = port["indivisible" if case == "indivisible"
                else "kv4_attn8_packed"][0]
    for toks, rep in (r[case] for r in worlds[2]["engine"]):
        assert toks == want, case
        assert rep["tp"] == 1 and rep["tp_requested"] in (2, 4), rep
        assert reason in rep["tp_fallback_reason"], rep
        assert rep["decode_route"] == "cuda_block_table", rep


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_writes_and_gather_are_pure_relayout(worlds, n):
    assert worlds[n]["pool"] == [[]] * n


@pytest.mark.parametrize("n", [2, 4])
def test_flash_decode_matches_teacher_forcing(worlds, n):
    for res in worlds[n]["flash"]:
        for case, (err, sharded, divides) in res.items():
            assert err < FLASH_TOL, (case, n, err)
            assert sharded == divides, (case, n)
    assert worlds[n]["flash"][0]["S16"][1]          # flash decode ran


def test_tp_narrower_than_the_group_is_refused(worlds):
    for res in worlds[4]["engine"]:
        assert "less than the active group's 4 ranks" in res["narrow"], res
    assert "Graphed TP decode step" in TE.GRAPHED_TP_ITEM


POOL_CTX = dict(batch=4, page_size=16, max_pages=16, kv_heads=8, hd=128,
                n_pages=80)


@pytest.mark.parametrize("policy", ["kv4_attn8_packed", "w4a8_kv4_attn8",
                                    "kv8_attn_f32"])
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", ["paged_decode", "verify_attn"])
def test_sharded_routes_price_the_reference_wire(op, n, policy):
    ctx = dict(POOL_CTX, n_devices=n, **({"sq": 5} if op == "verify_attn"
                                         else {}))
    d = exec_plan.describe(op, policy, **ctx)
    assert d["route"] == f"{op}_sharded"
    one = exec_plan.describe(op, policy, **dict(ctx, n_devices=1))
    wire = RREG._tp_wire_bytes(RPOL.get_policy(policy), ctx)
    assert wire > 0
    assert d["bytes_moved"] == one["bytes_moved"] + wire
    assert one["route"] == "cuda_block_table"
    assert get_policy(policy).kv_quantized
