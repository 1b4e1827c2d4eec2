"""The serving steps as one program (`launch.graphs`), on the CPU.

A CUDA graph needs the card; what makes a step capturable does not:

- offsets given as 0-dim integer tensors (what a captured step reads
  from its buffer) give bit-identical masks, attention outputs, rope
  positions and raw-cache writes to Python-int offsets, also where the
  write clamps;
- the port's `make_serve_step` gives the reference's `make_serve_step`'s
  tokens on the same weights and inputs;
- no host sync: with the Tensor methods that read a value to the host
  patched to raise, the engine's decode-step and prefill-chunk functions
  and the serve step each run once;
- `StepGraph` refuses a CPU device, and the launch counters' delta,
  taken back at capture and added once per replay, adds up.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import kvcache as KV  # noqa: E402
from repro_torch.distributed.step import make_serve_step  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.launch import graphs  # noqa: E402
from repro_torch.launch.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import decode_attn as D  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")


def _t(offset):
    return torch.tensor(offset, dtype=torch.int32)


# -----------------------------------------------------------------------------
# tensor offsets == int offsets, bit for bit
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("offset", [0, 3, 9])
@pytest.mark.parametrize("causal,window,valid", [
    (True, None, False), (True, 4, False), (False, None, True),
    (True, 2, True)])
def test_sdpa_mask_tensor_offset(offset, causal, window, valid):
    keep = torch.arange(12) % 3 != 1 if valid else None
    want = D.build_sdpa_mask(4, 12, offset, causal, window, keep)
    got = D.build_sdpa_mask(4, 12, _t(offset), causal, window, keep)
    assert got.dtype == torch.bool and torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 5, 15])
@pytest.mark.parametrize("fmt_kv,packed", [("fp8_e4m3", False),
                                           ("fp4_e2m1", True)])
def test_dpa_decode_attn_tensor_offset(offset, fmt_kv, packed):
    rng = np.random.default_rng(offset)
    k, v = (torch.from_numpy(rng.standard_normal((2, 16, 2, 16)).astype(
        np.float32)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16)).astype(
        np.float32))
    cache = KV.update_kv_cache(
        KV.init_kv_cache(2, 16, 2, 16, fmt=fmt_kv, packed=packed), k, v, 0,
        fmt=fmt_kv, packed=packed)
    kw = dict(fmt="fp8_e4m3", fmt_kv=fmt_kv, kv_packed=packed, scale=0.25)
    want = D.dpa_decode_attn(q, cache, offset, **kw)
    got = D.dpa_decode_attn(q, cache, _t(offset), **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 7])
def test_positions_tensor_offset(offset):
    want = L._positions(offset, 2, 5, "cpu")
    got = L._positions(_t(offset), 2, 5, "cpu")
    assert got.dtype == want.dtype == torch.int64
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [0, 4, 13, 15, 40])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_raw_cache_write_tensor_offset(offset, dtype):
    """Path B's raw cache: S_new = 3 rows into 16, clamped past 13."""
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(
        np.float32)).to(dtype)
    new = torch.from_numpy(rng.standard_normal((2, 3, 2, 8)).astype(
        np.float32)).to(dtype)
    want = KV.write_rows(base.clone(), new, offset)
    got = KV.write_rows(base.clone(), new, _t(offset))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    start = min(offset, 13)
    assert torch.equal(want[:, start:start + 3].view(bits), new.view(bits))


# -----------------------------------------------------------------------------
# make_serve_step against the reference's
# -----------------------------------------------------------------------------

B, S = 2, 10


@functools.lru_cache(maxsize=None)
def _pair(name, policy):
    rcfg = RCFG.reduce_config(RCFG.get_config(name)).replace(policy=policy)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tcfg = reduce_config(get_config(name)).replace(policy=policy)
    tmodel = build_model(tcfg, device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


@pytest.mark.parametrize("name,policy", [
    ("qwen3-4b", "w4a8_kv4_attn8"), ("granite-moe-1b-a400m",
                                     "fp4_dpa_packed")])
def test_serve_step_matches_reference(name, policy):
    """Teacher-forced over the same tokens: every step's next tokens."""
    rmodel, rparams, tmodel, tparams = _pair(name, policy)
    toks = np.random.default_rng(4).integers(0, 256, size=(B, S))
    rstep = jax.jit(RSTEP.make_serve_step(rmodel))
    tstep = make_serve_step(tmodel)
    rc, tc = rmodel.init_caches(B, 16), tmodel.init_caches(B, 16)
    for t in range(S):
        want, rc = rstep(rparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                   "index": jnp.int32(t)}, rc)
        got, tc = tstep(tparams, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                  "index": _t(t)}, tc)
        assert got.dtype == torch.int32 and got.shape == (B,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"step {t}")


# -----------------------------------------------------------------------------
# no host sync inside a step
# -----------------------------------------------------------------------------

HOST_READS = ("item", "__int__", "__index__", "__bool__", "__float__",
              "tolist", "cpu", "numpy")


def _trap(monkeypatch):
    def raiser(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host sync inside the step: Tensor.{name}")
        return read
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, raiser(name))


ECFG = EngineConfig(page_size=8, n_pages=16, max_batch=3,
                    max_pages_per_req=4, token_budget=8, prefill_chunk=8)


@pytest.mark.parametrize("step", ["decode step", "prefill chunk"])
@pytest.mark.parametrize("name", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_engine_steps_make_no_host_sync(monkeypatch, name, step):
    cfg = reduce_config(get_config(name)).replace(policy="w4a8_kv4_attn8")
    model = build_model(cfg, device="cpu")
    engine = Engine(model, model.init(torch.Generator().manual_seed(0)),
                    ECFG, device="cpu")
    run = {"decode step": engine._decode,
           "prefill chunk": engine._prefill}[step]
    assert run.name == step
    _trap(monkeypatch)
    out = run.fn(**run.buffers)
    monkeypatch.undo()
    assert out.shape == ((ECFG.max_batch,) if step == "decode step" else
                         (1, ECFG.prefill_chunk, cfg.vocab_size))


@pytest.mark.parametrize("name,policy", [
    ("qwen3-4b", "w4a8_kv4_attn8"), ("granite-moe-1b-a400m",
                                     "fp4_dpa_packed")])
def test_serve_step_makes_no_host_sync(monkeypatch, name, policy):
    cfg = reduce_config(get_config(name)).replace(policy=policy)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_caches(2, 16)
    batch = {"tokens": torch.zeros((2, 1), dtype=torch.int64),
             "index": _t(3)}
    step = make_serve_step(model)
    _trap(monkeypatch)
    nxt, _ = step(params, batch, caches)
    monkeypatch.undo()
    assert nxt.shape == (2,) and nxt.dtype == torch.int32


# -----------------------------------------------------------------------------
# StepGraph and the launch counters
# -----------------------------------------------------------------------------

def test_step_graph_refuses_the_cpu():
    calls = []
    with pytest.raises(ValueError, match="on the card"):
        graphs.StepGraph(lambda x: calls.append(x), {"x": torch.zeros(2)})
    assert calls == []                    # refused before any warm-up


def test_eager_step_loads_host_and_device_inputs():
    step = graphs.Step(lambda a, i: a * 2 + i,
                       {"a": torch.zeros(3, dtype=torch.int64),
                        "i": torch.zeros((), dtype=torch.int32)})
    assert step.first().tolist() == [0, 0, 0]
    assert step(a=np.array([1, 2, 3]), i=4).tolist() == [6, 8, 10]
    assert step(a=torch.tensor([0, 1, 0]), i=torch.tensor(1)).tolist() == \
        [1, 3, 1]
    assert step.buffers["i"].dtype == torch.int32


def _stub():
    def stub():
        stub.launches += 1
        stub.splitk_launches += 1
    stub.launches = 0
    stub.splitk_launches = 0
    return stub


def test_counter_delta_adds_once_per_replay():
    """What `StepGraph` does with the counters: snapshot, capture (two
    launches recorded), take the delta back, then add it per replay."""
    stub = _stub()
    wrappers = {"stub": stub}
    stub()                                         # a warm-up launch
    before = counters.snapshot(wrappers)
    stub()
    stub()
    delta = counters.diff(counters.snapshot(wrappers), before)
    assert delta == {"stub": 2, "stub.splitk": 2}
    counters.add(delta, -1, wrappers)
    assert counters.snapshot(wrappers) == before == {"stub": 1,
                                                     "stub.splitk": 1}
    for _ in range(5):
        counters.add(delta, wrappers=wrappers)
    assert counters.snapshot(wrappers) == {"stub": 11, "stub.splitk": 11}
    counters.zero(wrappers)
    assert counters.snapshot(wrappers) == {"stub": 0, "stub.splitk": 0}


def test_counters_list_every_kernel_wrapper():
    snap = counters.snapshot()
    assert set(counters.WRAPPERS) == {
        "dpa_matmul_fused", "paged_decode_attention", "dpa_matmul_prequant",
        "dpa_grouped_matmul_fused", "dpa_grouped_matmul_prequant",
        "dpa_flash_attention", "flash_attention", "quantize_rows",
        "quantize_pack_rows", "dpa_act_quant"}
    assert {k for k in counters.launches(snap) if "." in k} == {
        "dpa_matmul_fused.splitk", "dpa_grouped_matmul_fused.splitk",
        "dpa_matmul_fused.tiled", "dpa_grouped_matmul_fused.tiled",
        "dpa_flash_attention.prepass", "flash_attention.prepass",
        "paged_decode_attention.fp8_e4m3", "paged_decode_attention.fp4_e2m1",
        "paged_decode_attention.fp16", "paged_decode_attention.fp32",
        "paged_decode_attention.bf16", "paged_decode_attention.fp8_e5m2",
        "paged_decode_attention.verify"} | {
        f"{w}.{f}" for w in ("dpa_matmul_fused", "dpa_grouped_matmul_fused")
        for f in ("fp8_e4m3", "fp4_e2m1", "fp16")}
    # beside each launch counter, the census of the launches it counts
    assert set(snap) == {f"{k}{w}" for k in counters.launches(snap)
                         for w in ("", ":bytes", ":ops", ":bound_s")}


def test_failed_capture_names_the_port_line():
    try:
        L._positions(object(), 1, 2, "cpu")
    except TypeError as e:
        where = graphs._broke_at(e)
    assert where.startswith("at layers.py:") and "int(offset)" in where
