"""Reduced granite-moe-1b-a400m through the port's engine: it equals the
port's `generate` token for token with `prefill_chunk=1` (expert capacity
is computed per model call, so only single-token prefill routes a prompt
as `generate` does), as `tests/test_grouped_dpa.py` pins the reference,
and its report states the grouped plan.

These tests sit in a file of their own so that a run distributed by file
puts their time on another worker than `tests/test_torch_moe.py`'s.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch.engine import (Engine, EngineConfig,  # noqa: E402
                                       Request)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

RCFG = importlib.import_module("repro.configs")

NAME = "granite-moe-1b-a400m"


def _cfgs(policy, **kw):
    rcfg = RCFG.reduce_config(RCFG.get_config(NAME)).replace(policy=policy,
                                                             **kw)
    tcfg = reduce_config(get_config(NAME)).replace(policy=policy, **kw)
    return rcfg, tcfg


ECFG = EngineConfig(page_size=8, n_pages=32, max_batch=3,
                    max_pages_per_req=4, token_budget=8, prefill_chunk=1)
LENS = [(6, 4), (9, 3), (5, 4)]


@functools.lru_cache(maxsize=None)
def _served():
    _, tcfg = _cfgs("w4a8_kv4_attn8")
    model = build_model(tcfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, size=s0)
                    .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(LENS)]
    engine = Engine(model, params, ECFG, device="cpu")
    return model, params, engine, reqs, engine.run(reqs)


def test_engine_matches_generate_per_request():
    model, params, _, reqs, _ = _served()
    for req in reqs:
        out = generate(model, params, req.prompt[None], req.max_new,
                       ECFG.s_max, device="cpu").numpy()[0]
        assert np.array_equal(req.tokens(), out), req.rid


def test_engine_report_states_grouped_plan():
    _, _, engine, reqs, rep = _served()
    assert rep["n_requests"] == len(LENS) and engine.alloc.in_use == 0
    assert rep["moe_experts"] == 8 and rep["moe_top_k"] == 2
    assert rep["moe_grouped_route"] == "cuda_grouped_fused"
    assert rep["moe_grouped_backend"] == "cuda"
    assert rep["moe_grouped_selection"] == "prior"
    # packed fp4 expert weights: exactly 8x under the f32 masters
    assert rep["expert_w_reduction_vs_f32"] == pytest.approx(8.0)
    assert rep["expert_w_bytes_f32"] == 2 * 3 * 8 * 64 * 128 * 4
    assert rep["moe_grouped_bytes_per_step_layer"] > 0
    assert rep["decode_route"] == "cuda_block_table"


def test_dense_decoder_reports_no_moe_fields():
    cfg = reduce_config(get_config("qwen3-4b")).replace(
        policy="kv4_attn8_packed")
    model = build_model(cfg, device="cpu")
    engine = Engine(model, model.init(torch.Generator().manual_seed(0)),
                    ECFG, device="cpu")
    assert engine.moe_plan is None
    assert not any(k.startswith("moe_") for k in engine.report(1.0))
