"""The port's tuner (`repro_torch.runtime.tuner`), its consult in
`core.exec_plan`, the launch-plan overrides, `launch.tune` and
`launch.plan_table`, on the CPU.

- Parity with the reference (`repro.runtime.tuner`): `policy_key` for
  every preset, `classify` on a grid of contexts for every op, and the
  engine pseudo-op's `synthetic_workload` requests for seeds 0 and 1.
- Selection invariance (the reference's `tests/test_tuner.py`): a DB only
  reorders within the static choice's family, within the route's pin of
  its reference; unknown, ineligible and out-of-family routes and unknown
  or refused knobs warn and give the prior; corrupt and partial DBs are
  ignored with one warning; `save_db` is atomic; a sweep skips what is
  measured and the hash shards cover the space once.
- The port's departures: records of another torch, CUDA or device and
  of another shape are never selected; split-K knobs are keyed without
  M; a `torch` route is never selected over a kernel; no environment
  variable opens the consult.
- The plan overrides at the layer shapes of six configurations: plan
  or `ValueError`, never a launch the automatic checks would refuse.
- The engine pseudo-op keeps its speculative points at the card's
  geometry.
- End to end: reduced qwen3-4b's greedy engine tokens equal with a
  tuned DB (page size 8) and without, and the JAX engine's; `launch.tune
  --device cpu --smoke` then `--verify`; `plan_table --check` passes
  and flags a planted undeclared knob and a stale record.
"""
import dataclasses
import functools
import importlib
import itertools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.core.policy import POLICIES, get_policy  # noqa: E402
from repro_torch.kernels import dpa_matmul as DM  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import quantize as QZ  # noqa: E402
from repro_torch.kernels.registry import _mm_dims  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import plan_table as PT  # noqa: E402
from repro_torch.launch import tune as TUNE  # noqa: E402
from repro_torch.runtime import tuner  # noqa: E402

RT = importlib.import_module("repro.runtime.tuner")
RE = importlib.import_module("repro.launch.engine")
RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")

CONFIGS = ("qwen3-4b", "granite-moe-1b-a400m", "recurrentgemma-9b",
           "xlstm-1.3b", "whisper-medium", "pixtral-12b")


@pytest.fixture(autouse=True)
def _isolation():
    """No DB active and cold tuner caches around each test."""
    before = exec_plan.use_tuned_db(None)
    tuner.clear_caches()
    yield
    exec_plan.use_tuned_db(before)
    tuner.clear_caches()


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


def _cfg(op, policy, cls, route, knobs=None, shape=None, **env):
    return {"op": op, "policy": policy,
            "policy_key": tuner.policy_key(policy), "shape_class": cls,
            "shape": shape if shape is not None else _SHAPES[(op, cls)],
            "route": route, "knobs": dict(knobs or {}), "ctx": _CTX[op],
            **dict(tuner.env_fingerprint(), **env)}


def _write_db(path, cfgs, us=1.0):
    """A DB of `cfgs`, the first the fastest."""
    records = {tuner.config_hash(c): {**c, "us": us + i, "reps": 1,
                                      "spread": 0.0}
               for i, c in enumerate(cfgs)}
    tuner.save_db(str(path), {"meta": {}, "records": records})
    return str(path)


# resolve contexts (reduced widths) and their shape keys
_CTX = {
    "matmul": dict(w_dtype="float32", m=4, k=256, n=128),
    "grouped_matmul": dict(w_dtype="float32", eq="gti,gio->gto", e=4, m=8,
                           k=128, n=64),
    "flash_attn": dict(sq=32, skv=32, hd=16, use_flash=True,
                       has_valid=False, kv_on_grid=False),
    "paged_decode": dict(batch=2, page_size=8, max_pages=3, kv_heads=2,
                         hd=16, n_pages=8),
    "verify_attn": dict(batch=2, page_size=8, max_pages=3, kv_heads=2,
                        hd=16, n_pages=8, sq=3),
    "quantize_pack": dict(fmt="fp4_e2m1", pack=True, m=16, k=64),
}
_SHAPES = {("matmul", "gemm_decode"): [1, 256, 128],
           ("matmul", "gemm_prefill"): [1, 256, 128],
           ("grouped_matmul", "moe_experts"): [4, 128, 64],
           ("flash_attn", "flash_prefill"): [16, 32, 32],
           ("paged_decode", "paged_single"): [2, 2, 16, 8, 3],
           ("verify_attn", "verify_paged"): [2, 2, 16, 8, 3, 3],
           ("quantize_pack", "qp_fp4_pack"): [16, 64]}


# -----------------------------------------------------------------------------
# parity with the reference
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("preset", sorted(POLICIES))
def test_policy_key_equals_reference(preset):
    assert tuner.policy_key(preset) == RT.policy_key(preset)


def _ctx_grid():
    for m, e, sq, valid, nd, fmt, pack in itertools.product(
            (None, 0, 1, 8, 16, 17, 128), (None, 4), (None, 1, 2, 32),
            (False, True), (None, 1, 2), ("fp4_e2m1", "fp8_e4m3"),
            (False, True)):
        ctx = {"has_valid": valid, "fmt": fmt, "pack": pack}
        for key, val in (("m", m), ("e", e), ("sq", sq), ("n_devices", nd)):
            if val is not None:
                ctx[key] = val
        yield ctx


@pytest.mark.parametrize("op", ["matmul", "grouped_matmul", "flash_attn",
                                "paged_decode", "verify_attn",
                                "quantize_pack", "decode_attn"])
def test_classify_equals_reference(op):
    for ctx in _ctx_grid():
        assert tuner.classify(op, ctx) == RT.classify(op, ctx), (op, ctx)
    assert [(s.op, s.name) for s in tuner.SHAPE_CLASSES] == \
        [(s.op, s.name) for s in RT.SHAPE_CLASSES]


@pytest.mark.parametrize("seed", [0, 1])
def test_synthetic_workload_equals_reference(seed):
    for kw in (dict(vocab=256, prompt_range=(8, 24), gen_range=(4, 10)),
               dict(vocab=211, rate=2.0, prompt_range=(4, 12),
                    gen_range=(2, 6), shared_prefix=4)):
        ours = TE.synthetic_workload(6, seed=seed, **kw)
        ref = RE.synthetic_workload(6, seed=seed, **kw)
        assert [(r.rid, r.max_new, r.arrival) for r in ours] == \
            [(r.rid, r.max_new, r.arrival) for r in ref]
        for a, b in zip(ours, ref):
            assert np.array_equal(a.prompt, np.asarray(b.prompt))


def test_config_hash_stable_across_key_order_and_whitespace():
    cfg = _cfg("matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
               {"bn": 32, "split": 2})
    h = tuner.config_hash(cfg)
    shuffled = {k: cfg[k] for k in reversed(list(cfg))}
    assert tuner.config_hash(shuffled) == h
    assert tuner.config_hash(json.dumps(shuffled, indent=4)) == h
    assert tuner.config_hash(dict(cfg, knobs={"split": 2, "bn": 32})) == h
    assert tuner.config_hash(dict(cfg, ctx={"m": 99})) == h
    for change in (dict(knobs={"bn": 64, "split": 2}),
                   dict(route="cuda_prequant"), dict(shape=[1, 256, 256]),
                   dict(torch="0.0"), dict(cuda="11.0"),
                   dict(device="another card")):
        assert tuner.config_hash(dict(cfg, **change)) != h, change


# -----------------------------------------------------------------------------
# selection invariance
# -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _space():
    return [c for c in tuner.enumerate_space(smoke=True)
            if c["op"] != tuner.ENGINE_OP]


def _out_leaves(out):
    return [t.detach().to(torch.float64).numpy()
            for t in (out if isinstance(out, tuple) else (out,))]


def test_tuned_only_reorders_within_reference_family(tmp_path):
    """Every config of the smoke space forced through a one-record DB:
    the consult picks exactly that route with those knobs, inside the
    static choice's family, and its output stays within the route's pin
    of the family reference (the plain versions on the CPU)."""
    space = _space()
    assert {c["op"] for c in space} == set(tuner.OP_POLICIES)
    for i, cfg in enumerate(space):
        exec_plan.use_tuned_db(_write_db(tmp_path / f"f{i}.json", [cfg]))
        pol = get_policy(cfg["policy"])
        entry = exec_plan.resolve(cfg["op"], pol, **cfg["ctx"])
        assert entry.name == cfg["route"] and entry.tuned, cfg
        assert dict(entry.tuned_knobs) == cfg["knobs"], cfg
        static = tuner._prior(cfg["op"], pol, cfg["ctx"])
        assert tuner._family(entry) & tuner._family(static)
        calls, _ = tuner.cutout(cfg)
        base = exec_plan.route(cfg["op"], cfg["route"])
        ref = exec_plan.reference_entry(base) or base
        got = _out_leaves(entry.run(*calls[0].args, **{
            k: v for k, v in calls[0].keywords.items()
            if k not in cfg["knobs"]}))
        want = _out_leaves(ref.run(*calls[0].args, **{
            k: v for k, v in calls[0].keywords.items()
            if k not in cfg["knobs"]}))
        tol = base.tol(pol, cfg["ctx"]) if callable(base.tol) else base.tol
        for g, w in zip(got, want):
            if tol == 0.0:
                assert np.array_equal(g, w), cfg
            else:
                err = np.max(np.abs(g - w)) / max(1e-6, np.max(np.abs(w)))
                assert err <= tol + 5e-6, cfg


@pytest.mark.parametrize("op,cls", [("paged_decode", "paged_single"),
                                    ("verify_attn", "verify_paged")])
def test_bit_pinned_ops_identical_tuned_vs_off(op, cls, tmp_path):
    """The paged ops declare no knobs and keep their kernel route: a
    record of the kernel route is selected and gives the prior's bits, a
    record of the plain route is refused."""
    pol = get_policy("w4a8_kv4_attn8")
    cfg = dict(_space_cfg(op), knobs={})
    calls, _ = tuner.cutout(cfg)
    static = exec_plan.resolve(op, pol, **cfg["ctx"])
    want = static.run(*calls[0].args, **calls[0].keywords)
    exec_plan.use_tuned_db(_write_db(tmp_path / "k.json", [cfg]))
    entry = exec_plan.resolve(op, pol, **cfg["ctx"])
    assert entry.tuned and entry.name == "cuda_block_table"
    assert torch.equal(entry.run(*calls[0].args, **calls[0].keywords), want)
    tuner.clear_caches()
    exec_plan.use_tuned_db(_write_db(tmp_path / "g.json", [
        dict(cfg, route="torch_gather")]))
    with pytest.warns(UserWarning, match="reference family"):
        entry = exec_plan.resolve(op, pol, **cfg["ctx"])
    assert entry is static


def _space_cfg(op):
    return next(c for c in _space() if c["op"] == op)


@pytest.mark.parametrize("case,route,knobs,match", [
    ("unknown_route", "no_such_kernel", {}, "unknown route"),
    ("ineligible", "cuda_prequant", {}, "not eligible"),
    ("out_of_family", "torch_f32", {}, "reference family"),
    ("plain_over_kernel", "torch_fake_quant", {}, "reference family"),
    ("unknown_knobs", "cuda_fused", {"bm": 32}, "unknown knob"),
    ("refused_knobs", "cuda_fused", {"bn": 64, "split": 3}, "refused")])
def test_bad_record_warns_and_gives_the_prior(case, route, knobs, match,
                                              tmp_path):
    pol = get_policy("w4a8_kv4_attn8")
    ctx = _CTX["matmul"]
    prior = exec_plan.resolve("matmul", pol, **ctx)
    assert prior.name == "cuda_fused" and not prior.tuned
    exec_plan.use_tuned_db(_write_db(tmp_path / "db.json", [_cfg(
        "matmul", "w4a8_kv4_attn8", "gemm_decode", route, knobs)]))
    with pytest.warns(UserWarning, match=match):
        entry = exec_plan.resolve("matmul", pol, **ctx)
    assert entry is prior
    assert exec_plan.describe("matmul", pol, **ctx)["selection"] == "prior"


def test_tuned_resolve_deterministic_and_describe(tmp_path):
    pol = get_policy("w4a8_kv4_attn8")
    ctx = _CTX["matmul"]
    prior = exec_plan.resolve("matmul", pol, **ctx)
    assert prior.describe(pol, ctx)["selection"] == "prior"
    db = _write_db(tmp_path / "db.json", [_cfg(
        "matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
        {"bn": 32, "split": 2})])
    exec_plan.use_tuned_db(db)
    first = exec_plan.resolve("matmul", pol, **ctx)
    for _ in range(3):
        assert exec_plan.resolve("matmul", pol, **ctx) is first
    d = exec_plan.describe("matmul", pol, **ctx)
    assert d["selection"] == "tuned" and d["shape_class"] == "gemm_decode"
    assert d["tuned_knobs"] == {"bn": 32, "split": 2}
    assert exec_plan.use_tuned_db(None) == db
    assert exec_plan.resolve("matmul", pol, **ctx) is prior


def test_no_environment_variable_opens_the_consult(tmp_path, monkeypatch):
    db = _write_db(tmp_path / "db.json", [_cfg(
        "matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
        {"bn": 32, "split": 2})])
    monkeypatch.setenv("REPRO_TUNED_DB", db)
    monkeypatch.setenv("REPRO_TUNED", "1")
    entry = exec_plan.resolve("matmul", "w4a8_kv4_attn8", **_CTX["matmul"])
    assert not entry.tuned and exec_plan.tuned_db() is None


def test_corrupt_and_partial_db_entries_ignored(tmp_path):
    pol = get_policy("w4a8_kv4_attn8")
    good = _cfg("matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
                {"bn": 32, "split": 2})
    records = {tuner.config_hash(good): {**good, "us": 1.0, "reps": 1},
               "deadbeefdeadbeef": {"op": "matmul"},
               "feedfacefeedface": "not even a dict",
               "0123456789abcdef": {**good, "us": -3.0},
               "0123456789abcde0": {**good, "us": 2.0, "shape": "1x2"}}
    path = tmp_path / "dirty.json"
    path.write_text(json.dumps({"version": 1, "records": records}))
    with pytest.warns(UserWarning, match="corrupt/partial") as rec:
        db = tuner.load_db(str(path))
    assert len(rec) == 1
    assert list(db["records"]) == [tuner.config_hash(good)]
    exec_plan.use_tuned_db(str(path))
    entry = exec_plan.resolve("matmul", pol, **_CTX["matmul"])
    assert entry.tuned and dict(entry.tuned_knobs) == {"bn": 32, "split": 2}
    path.write_text("{definitely not json")
    tuner.clear_caches()
    with pytest.warns(UserWarning, match="unreadable"):
        entry = exec_plan.resolve("matmul", pol, **_CTX["matmul"])
    assert not entry.tuned


def test_save_db_is_atomic_and_loadable(tmp_path):
    path = tmp_path / "nested" / "db.json"
    tuner.save_db(str(path), {"meta": {"device": "cpu"}, "records": {"ab": {
        "op": "matmul", "policy_key": "x", "shape_class": "c", "route": "r",
        "us": 2.0}}})
    assert tuner.load_db(str(path))["records"]["ab"]["us"] == 2.0
    assert not os.path.exists(str(path) + ".tmp")


def test_sweep_skips_measured_and_shards_cover_space_once(tmp_path):
    db = str(tmp_path / "sweep.json")
    space = tuner.enumerate_space(smoke=True, ops=["quantize_pack"])
    hashes = [tuner.config_hash(c) for c in space]
    assert len(set(hashes)) == len(hashes) > 4
    for n in (2, 3, 5):
        assert sorted(h for i in range(n) for h in hashes
                      if tuner.shard_of(h, n) == i) == sorted(hashes)
    seen = []

    def stub(cfg, reps):
        seen.append(tuner.config_hash(cfg))
        return {"us": 1.0 + len(seen), "reps": reps, "spread": 0.0}

    kw = dict(smoke=True, reps=1, ops=["quantize_pack"], measure=stub)
    s0 = tuner.run_sweep(db, shard=(0, 2), **kw)
    s1 = tuner.run_sweep(db, shard=(1, 2), **kw)
    assert s0["measured"] + s1["measured"] == len(space)
    assert s0["measured"] == s1["other_shard"]
    assert sorted(seen) == sorted(hashes)
    assert not any(c["op"] == "quantize_pack"
                   for c in tuner.missing_configs(db, smoke=True))
    again = tuner.run_sweep(db, shard=(0, 1), **kw)
    assert again["measured"] == 0 and again["skipped"] == len(space)


# -----------------------------------------------------------------------------
# the port's departures
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["torch", "cuda", "device"])
def test_record_of_another_environment_never_selected(field, tmp_path):
    exec_plan.use_tuned_db(_write_db(tmp_path / "db.json", [_cfg(
        "matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
        {"bn": 32, "split": 2}, **{field: "another"})]))
    with pytest.warns(UserWarning, match="another"):
        entry = exec_plan.resolve("matmul", "w4a8_kv4_attn8",
                                  **_CTX["matmul"])
    assert not entry.tuned


def test_record_of_another_shape_never_selected(tmp_path):
    exec_plan.use_tuned_db(_write_db(tmp_path / "db.json", [_cfg(
        "matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
        {"bn": 32, "split": 2}, shape=[1, 256, 256])]))
    assert not exec_plan.resolve("matmul", "w4a8_kv4_attn8",
                                 **_CTX["matmul"]).tuned
    assert exec_plan.resolve("matmul", "w4a8_kv4_attn8",
                             **dict(_CTX["matmul"], n=256)).tuned


def test_splitk_knobs_are_keyed_without_m(tmp_path):
    """A decode step (M 4) and a verify pass (M 20, another shape class)
    take the same split-K knobs: the fused route reads the decode class's
    records at every M, and a record of the prefill class is not read."""
    exec_plan.use_tuned_db(_write_db(tmp_path / "db.json", [
        _cfg("matmul", "w4a8_kv4_attn8", "gemm_decode", "cuda_fused",
             {"bn": 32, "split": 2}),
        _cfg("matmul", "w4a8_kv4_attn8", "gemm_prefill", "cuda_fused",
             {"bn": 64, "split": 1})]))
    got = {}
    for m in (4, 20, 128):
        d = exec_plan.describe("matmul", "w4a8_kv4_attn8",
                               **dict(_CTX["matmul"], m=m))
        assert d["selection"] == "tuned" and d["shape_class"] == "gemm_decode"
        got[m] = d["tuned_knobs"]
    assert got[4] == got[20] == got[128] == {"bn": 32, "split": 2}
    assert DM.fused_plan(1, 8, 256, 128, **got[4])[2:4] == \
        DM.fused_plan(1, 32, 256, 128, **got[20])[2:4]


def test_no_plain_route_over_a_kernel(tmp_path):
    """With a static `cuda` route (the table resolved for a kernel
    policy, no tensor in sight), a record naming a `torch` route of its
    family is refused; where the static route is `torch` it is taken."""
    pol = get_policy("w4a8_kv4_attn8")
    ctx = _CTX["flash_attn"]
    static = exec_plan.resolve("flash_attn", pol, **ctx)
    assert static.name == "cuda_dpa_flash"
    exec_plan.use_tuned_db(_write_db(tmp_path / "db.json", [_cfg(
        "flash_attn", "w4a8_kv4_attn8", "flash_prefill", "torch_dpa_attn")]))
    with pytest.warns(UserWarning, match="reference family"):
        assert exec_plan.resolve("flash_attn", pol, **ctx) is static
    tuner.clear_caches()
    exec_plan.use_tuned_db(_write_db(tmp_path / "t.json", [_cfg(
        "matmul", "fp32", "gemm_decode", "torch_f32")]))
    entry = exec_plan.resolve("matmul", "fp32", **_CTX["matmul"])
    assert entry.tuned and entry.name == "torch_f32"


# -----------------------------------------------------------------------------
# the plan overrides
# -----------------------------------------------------------------------------

def _layer_shapes(name):
    shapes = tuner.linear_shapes(get_config(name))
    return [(1, k, n) for k, n in shapes["dense"]] + shapes["experts"]


@pytest.mark.parametrize("name", CONFIGS)
def test_plan_overrides_plan_or_raise(name):
    """Every (bn, split) of the grid at every layer shape of the config,
    at the decode step's and a prefill chunk's rows, through the fused
    and prequant plans: a plan whose launch the automatic checks allow,
    or `ValueError`; the flash blocks at 4,096 tokens and the quantizer's
    (lanes, nv) likewise."""
    cfg = get_config(name)
    grid = tuner.KNOB_GRID
    planned = refused = 0
    for (E, k, n), M in itertools.product(_layer_shapes(name), (8, 32)):
        ctx = dict(e=E, m=M, k=k, n=n)
        _, Mp, K, N = _mm_dims(ctx)
        for bn, split in itertools.product(grid["bn"], grid["split"]):
            try:
                p = DM.fused_plan(E, Mp, K, N, bn=bn, split=split)
            except ValueError:
                refused += 1
            else:
                planned += 1
                assert p.route == "splitk" and p.bn == bn and \
                    p.split == split and bn in DM.SPLITK_COLS
                assert N % bn == 0 and (K // DM.BK) % split == 0
                assert DM.splitk_smem_bytes(p.bm, bn, K, split) <= \
                    DM.SMEM_LIMIT
            if K < DM.K_EXACT:
                try:
                    q = DM.prequant_plan(E, Mp, K, N, bn=bn, split=split)
                except ValueError:
                    refused += 1
                else:
                    assert q.bn == bn and q.split == split and N % bn == 0
                    assert bn * q.row_tile <= DM.MAX_TILE
                    assert (K // DM.BK) % split == 0
        with pytest.raises(ValueError):
            DM.fused_plan(E, Mp, K + 64, N, bn=32, split=1)
    for bq, bk in itertools.product(grid["bq"], grid["bk"]):
        ctx = dict(hd=cfg.hd, sq=4096, skv=4096)
        try:
            got = exec_plan.route("flash_attn", "cuda_dpa_flash").plan(
                None, ctx, bq=bq, bk=bk)
        except ValueError:
            assert bq > FA.max_bq(cfg.hd)
        else:
            assert got == (bq, bk)
    for lanes, nv in itertools.product(grid["lanes"], grid["nv"]):
        p = QZ.quantize_plan(4096, cfg.d_model, torch.bfloat16, "fp8_e4m3",
                             lanes=lanes, nv=nv)
        assert p.lanes == lanes and p.nv == nv and p.rows * lanes <= 1024
        assert p.tiles == -(-(-(-cfg.d_model // p.width)) // (lanes * nv))
    with pytest.raises(ValueError):
        QZ.quantize_plan(16, 64, torch.float32, "fp8_e4m3", lanes=48, nv=2)
    with pytest.raises(ValueError):
        QZ.quantize_plan(16, 64, torch.float32, "fp8_e4m3", lanes=8, nv=5)
    assert planned and refused


def test_override_leaves_the_automatic_memo_alone():
    auto = DM.fused_plan(1, 8, 2560, 9728)
    hits = DM.fused_plan.cache_info().hits
    other = DM.fused_plan(1, 8, 2560, 9728, bn=32, split=1)
    assert other != auto and DM.fused_plan.cache_info().hits == hits
    assert DM.fused_plan(1, 8, 2560, 9728) is auto
    with pytest.raises(ValueError, match="together"):
        DM.prequant_plan(1, 8, 1024, 1024, bn=32)


def test_wrappers_check_overrides_on_the_cpu():
    """A CPU tensor takes the plain version, whose bits no plan changes,
    but a refused override raises there too."""
    from repro_torch.kernels.ops import prep_weights
    x = torch.randn((8, 256), generator=torch.Generator().manual_seed(0))
    prep = prep_weights(torch.randn((256, 128)), "w4a8_kv4_attn8")
    kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
    want = DM.dpa_matmul_fused(x, prep["wq"], prep["sw"], **kw)
    got = DM.dpa_matmul_fused(x, prep["wq"], prep["sw"], bn=32, split=2,
                              **kw)
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        DM.dpa_matmul_fused(x, prep["wq"], prep["sw"], bn=16, split=2, **kw)
    codes, scales = QZ.quantize_pack_rows(x, lanes=8, nv=2)
    assert torch.equal(codes, QZ.quantize_pack_rows(x)[0])
    with pytest.raises(ValueError):
        QZ.quantize_rows(x, fmt="fp8_e4m3", lanes=3, nv=1)


# -----------------------------------------------------------------------------
# end to end
# -----------------------------------------------------------------------------

GEOM = dict(max_batch=3, token_budget=16, prefill_chunk=8)
LENS = [(9, 5), (14, 7), (5, 4)]


def _requests(mod, vocab=256, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=s0)
                        .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(LENS)]


@functools.lru_cache(maxsize=None)
def _reference_params():
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(
        policy=tuner.ENGINE_POLICY)
    rparams = RMODELS.build_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, rparams


def test_engine_greedy_bit_identical_tuned_vs_off(tmp_path):
    """Reduced qwen3-4b under the engine pseudo-op's policy: with a DB
    whose engine records pick page size 8 (S_max kept) and whose op
    records tune every linear's route and ask for the plain paged route
    (refused), the greedy tokens equal the untuned engine's at page 16
    and the JAX engine's."""
    from repro_torch.models import build_model
    from repro_torch.models.convert import convert_params
    rcfg, rparams = _reference_params()
    cfg = reduce_config(get_config("qwen3-4b")).replace(
        policy=tuner.ENGINE_POLICY)
    model = build_model(cfg, device="cpu")
    params = convert_params(jax.tree.map(np.asarray, rparams), model)
    engine_rec = dict(op=tuner.ENGINE_OP, policy=tuner.ENGINE_POLICY,
                      policy_key=tuner.policy_key(tuner.ENGINE_POLICY),
                      shape_class=tuner.ENGINE_SHAPE_CLASS,
                      route=tuner.ENGINE_ROUTE, shape=["qwen3-4b", 1],
                      **tuner.env_fingerprint())
    k, n = cfg.d_model, cfg.n_heads * cfg.hd
    db = _write_db(tmp_path / "db.json", [
        dict(engine_rec, knobs={"page_size": 8, "spec_k": 0}),
        dict(engine_rec, knobs={"page_size": 16, "spec_k": 0}),
        _cfg("matmul", tuner.ENGINE_POLICY, "gemm_decode", "torch_f32",
             shape=[1, k, n]),
        _cfg("paged_decode", tuner.ENGINE_POLICY, "paged_single",
             "torch_gather", shape=[3, cfg.n_kv_heads, cfg.hd, 8, 6])])
    best = tuner.best_engine_knobs(db)
    assert best == {"page_size": 8, "spec_k": 0}

    def serve(ps, db_path):
        pool, rows = 48 * 8, 6 * 8
        ecfg = TE.EngineConfig(page_size=ps, n_pages=pool // ps,
                               max_pages_per_req=rows // ps, **GEOM)
        before = exec_plan.use_tuned_db(db_path)
        try:
            engine = TE.Engine(model, params, ecfg, device="cpu")
        finally:
            exec_plan.use_tuned_db(before)
        rep = engine.run(_requests(TE))
        return {r.rid: list(r.out_tokens) for r in engine.finished}, rep

    with pytest.warns(UserWarning, match="reference family"):
        tuned, rep = serve(best["page_size"], db)
    assert rep["tuned_db"] == db and rep["decode_selection"] == "prior"
    assert rep["linear_plans"][f"{k}x{n}"]["selection"] == "tuned"
    untuned, rep0 = serve(16, None)
    assert rep0["linear_plans"][f"{k}x{n}"]["selection"] == "prior"
    assert tuned == untuned and len(tuned) == len(LENS)
    rengine = RE.Engine(RMODELS.build_model(rcfg), rparams,
                        RE.EngineConfig(page_size=8, n_pages=48,
                                        max_pages_per_req=6, **GEOM))
    rengine.run(_requests(RE))
    assert tuned == {r.rid: list(r.out_tokens) for r in rengine.finished}


def test_engine_points_keep_spec_k_on_the_card(monkeypatch):
    """The engine pseudo-op's space at the card's geometry (full-width
    qwen3-4b, `CARD_ENGINE_GEOMETRY`) holds every (page_size, spec_k)
    point: speculation at k 2 and 4 is served on the card."""
    monkeypatch.setattr(tuner, "env_fingerprint", lambda device=None: {
        "torch": "t", "cuda": "c", "device": "card"})
    want = [{"page_size": ps, "spec_k": k} for ps in (8, 16)
            for k in (0, 2, 4)]
    assert tuner.engine_points(tuner.ENGINE_KNOB_GRID) == want
    space = tuner.enumerate_space(ops=(tuner.ENGINE_OP,), device="cuda")
    assert [c["knobs"] for c in space] == want
    assert all(c["ctx"] == tuner.CARD_ENGINE_GEOMETRY
               and c["shape"][1] == 0 for c in space)
    smoke = tuner.enumerate_space(smoke=True, ops=(tuner.ENGINE_OP,),
                                  device="cuda")
    assert [c["knobs"] for c in smoke] == [
        {"page_size": ps, "spec_k": 0} for ps in (8, 16)]


def test_tune_command_fills_a_db_that_verify_accepts(tmp_path, capsys):
    db = str(tmp_path / "tuned.json")
    assert TUNE.main(["--device", "cpu", "--smoke", "--db", db]) == 0
    assert "sweep: " in capsys.readouterr().out
    assert TUNE.main(["--device", "cpu", "--smoke", "--db", db,
                      "--verify"]) == 0
    out = capsys.readouterr().out
    assert "tune --verify: OK" in out and "[tuned]" in out
    assert PT.main(["--check", "--db", db]) == 0
    part = str(tmp_path / "part.json")
    assert TUNE.main(["--db", part, "--merge", db]) == 0
    assert tuner.load_db(part)["records"] == tuner.load_db(db)["records"]


def test_plan_table_check_passes_and_flags_plants(tmp_path):
    assert PT.main(["--check"]) == 0
    assert PT.collect()[1] == []

    def run(x, *, lanes=None):
        return x

    entry = exec_plan.PlanEntry(op="fake", name="r", backend="cuda",
                                run=run, predicate=lambda p, c: {})
    assert any("does not declare" in e for e in PT.knob_errors(entry))
    declared = dataclasses.replace(entry, knobs=("lanes",),
                                   plan=lambda p, c, **k: None)
    assert PT.knob_errors(declared) == []
    assert any("no grid" in e for e in PT.knob_errors(
        dataclasses.replace(declared, knobs=("no_such_knob",))))
    stale = _cfg("matmul", "w4a8_kv4_attn8", "gemm_decode", "route_gone")
    path = tmp_path / "stale.json"
    path.write_text(json.dumps({"records": {
        tuner.config_hash(stale): {**stale, "us": 1.0}}}))
    assert any("nonexistent route" in e for e in PT.db_errors(str(path)))
    good = dict(stale, route="cuda_fused", knobs={"bm": 8})
    path.write_text(json.dumps({"records": {"0" * 16: {**good, "us": 1.0}}}))
    errs = PT.db_errors(str(path))
    assert any("content hash" in e for e in errs)
    assert any("not declared" in e for e in errs)
    assert PT.main(["--check", "--db", str(path)]) == 1
