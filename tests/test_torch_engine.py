"""The port's continuous-batching engine on the CPU: per-request greedy
outputs equal the port's static `generate` token for token, under both
serving policies, with pages evicted back to the free list.

Both engine steps run through their static buffers (`launch.graphs.Step`;
on the CPU always eagerly), and `generate` through `make_serve_step`,
whose output is pinned to the stepped-decode loop it replaced.

The pin is exact.  Paging is pure relayout, prefill runs the same
quantized-cache path as the static path, and every plain product sums
each row in one fixed order whatever the batch (`rowwise_dot`), so row i
of an 8-token prefill chunk or a 3-slot decode step is bit-identical to
the batch-of-one step `generate` takes.  The geometry is
`tests/test_engine.py`'s.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch.engine import (Engine, EngineConfig,  # noqa: E402
                                       Request, synthetic_workload)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

POLICIES = ["kv4_attn8_packed", "w4a8_kv4_attn8"]
ECFG = EngineConfig(page_size=8, n_pages=32, max_batch=3,
                    max_pages_per_req=4, token_budget=8, prefill_chunk=8)
LENS = [(9, 5), (14, 7), (5, 4), (20, 6), (11, 8)]


@functools.lru_cache(maxsize=None)
def _model(policy):
    cfg = reduce_config(get_config("qwen3-4b")).replace(policy=policy)
    model = build_model(cfg, device="cpu")
    return model, model.init(torch.Generator().manual_seed(0))


def _requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab, size=s0).astype(np.int32),
                    max_new=g)
            for i, (s0, g) in enumerate(LENS)]


@functools.lru_cache(maxsize=None)
def _served(policy):
    model, params = _model(policy)
    engine = Engine(model, params, ECFG, device="cpu")
    reqs = _requests(model.cfg.vocab_size)
    return engine, reqs, engine.run(reqs)


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_matches_generate_per_request(policy):
    model, params = _model(policy)
    engine, reqs, _ = _served(policy)
    for req in reqs:
        out = generate(model, params, req.prompt[None], req.max_new,
                       ECFG.s_max, device="cpu").numpy()[0]
        assert np.array_equal(np.asarray(req.out_tokens),
                              out[req.n_prompt:]), (policy, req.rid)
        assert np.array_equal(req.tokens(), out)


@pytest.mark.parametrize("policy", POLICIES)
def test_engine_finishes_and_evicts(policy):
    engine, reqs, report = _served(policy)
    assert report["n_requests"] == len(LENS)
    assert report["gen_tokens"] == sum(g for _, g in LENS)
    assert all(r.n_generated == r.max_new for r in reqs)
    assert engine.alloc.in_use == 0 and engine.alloc.peak_in_use > 0
    assert all(s is None for s in engine.slots)
    assert np.all(engine._table == 0)
    assert torch.all(engine._block_table == 0)
    # honest accounting: live <= paged < static layouts
    assert 0 < report["live_bytes"] <= report["paged_bytes"]
    assert report["paged_bytes"] < report["static_bytes"]
    assert report["static_bytes"] < report["static_f32_bytes"]
    assert report["decode_route"] == "cuda_block_table"
    assert report["decode_steps"] > 0 and report["prefill_calls"] > 0
    assert report["graphs"] is False and "capture" not in report


def test_engine_eager_argument_serves_the_same_tokens():
    model, params = _model("w4a8_kv4_attn8")
    engine = Engine(model, params, ECFG, device="cpu", graphs=False)
    reqs = _requests(model.cfg.vocab_size)
    engine.run(reqs)
    _, served, _ = _served("w4a8_kv4_attn8")
    for a, b in zip(reqs, served):
        assert a.out_tokens == b.out_tokens


def _stepped_loop(model, params, prompt, n_gen, s_ctx):
    """`generate` before `make_serve_step`: `decode_step` at a Python int
    index, then a plain argmax."""
    prompt = torch.as_tensor(prompt, dtype=torch.int64)
    S0 = prompt.shape[1]
    caches = model.init_caches(prompt.shape[0], s_ctx)
    tok = prompt[:, :1]
    toks = [tok]
    for t in range(S0 + n_gen - 1):
        logits, caches = model.decode_step(params, {"tokens": tok,
                                                    "index": t}, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        tok = prompt[:, t + 1:t + 2] if t + 1 < S0 else nxt[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1).to(torch.int32)


@pytest.mark.parametrize("name,policy", [
    ("qwen3-4b", "kv4_attn8_packed"), ("qwen3-4b", "w4a8_kv4_attn8"),
    ("granite-moe-1b-a400m", "fp4_dpa_packed")])
def test_generate_serve_step_matches_stepped_loop(name, policy):
    cfg = reduce_config(get_config(name)).replace(policy=policy)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                               size=(2, 9))
    got = generate(model, params, prompt, 6, 16, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 15)
    assert torch.equal(got, _stepped_loop(model, params, prompt, 6, 16))


def test_engine_queues_when_pool_is_tight():
    model, params = _model("kv4_attn8_packed")
    ecfg = EngineConfig(page_size=8, n_pages=8, max_batch=3,
                        max_pages_per_req=4, token_budget=8,
                        prefill_chunk=8)
    engine = Engine(model, params, ecfg, device="cpu")
    reqs = _requests(model.cfg.vocab_size)
    report = engine.run(reqs)
    assert report["n_requests"] == len(LENS)
    assert engine.alloc.peak_in_use <= 7
    _, served, _ = _served("kv4_attn8_packed")
    for a, b in zip(reqs, served):              # same tokens, tighter pool
        assert a.out_tokens == b.out_tokens


def test_engine_poisson_open_loop_and_workload_stream():
    model, params = _model("kv4_attn8_packed")
    reqs = synthetic_workload(6, vocab=model.cfg.vocab_size, seed=1,
                              rate=200.0, prompt_range=(4, 12),
                              gen_range=(2, 5))
    ref = importlib.import_module("repro.launch.engine").synthetic_workload(
        6, vocab=model.cfg.vocab_size, seed=1, rate=200.0,
        prompt_range=(4, 12), gen_range=(2, 5))
    for a, b in zip(reqs, ref):                 # the reference's stream
        assert np.array_equal(a.prompt, b.prompt)
        assert (a.max_new, a.arrival) == (b.max_new, b.arrival)
    engine = Engine(model, params, ECFG, device="cpu")
    report = engine.run(reqs)
    assert report["n_requests"] == 6 and engine.alloc.in_use == 0


def test_engine_rejects_bad_configurations():
    model, params = _model("kv4_attn8_packed")
    raw = build_model(model.cfg.replace(policy="fp32"), device="cpu")
    with pytest.raises(ValueError, match="fmt_kv"):
        Engine(raw, None, ECFG, device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(model, params, EngineConfig(page_size=8, max_pages_per_req=4,
                                           prefill_chunk=7), device="cpu")
    engine = Engine(model, params, ECFG, device="cpu")
    with pytest.raises(ValueError, match="S_max"):
        engine.submit(Request(rid=9, prompt=np.zeros(ECFG.s_max, np.int32),
                              max_new=1))
    from repro_torch.serving.sampler import SamplerConfig
    with pytest.raises(NotImplementedError):
        Engine(model, params, ECFG, device="cpu",
               sampler=SamplerConfig(temperature=0.7))


def test_greedy_tokens_masks_nan():
    from repro_torch.serving.sampler import greedy_tokens
    x = torch.tensor([[0.1, float("nan"), 0.3, 0.3],
                      [float("nan")] * 4,
                      [-1.0, -0.5, -0.5, -2.0]])
    assert greedy_tokens(x).tolist() == [2, 0, 1]
    assert greedy_tokens(x).dtype == torch.int32
