"""Reduced qwen3-4b with `use_flash`: the port's long-prompt prefill and
full-sequence scoring vs the JAX reference under `jax.jit` (its Pallas
flash kernels in interpret mode), on weights converted from the
reference's init and the same numpy tokens.

  prefill, fp8_dpa        the f32 flash route on both sides; last-position
                          logits within 1e-4 (as tests/test_torch_model.py
                          pins prefill).
  scoring, w4a8_kv4_attn8 the DPA flash route (raw K/V on the fp4 grid)
                          and the fused matmul kernel; loss within 1e-5
                          and logits within 1e-4, with `logits_chunk`
                          dividing S (chunked cross-entropy) and not.
  attn_fp8_dpa            the use_flash fault: before the port read
                          `use_flash`, it took the global-max DPA route
                          whatever the config said, and its logits missed
                          the reference's flash kernel by 2.8e-2 at S = 256
                          (two key blocks), against 5.7e-7 now.

Measured worst differences on these inputs: prefill logits 1.5e-7,
losses 4.8e-7, scoring logits 9.9e-6.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.distributed.step import (make_loss_fn,  # noqa: E402
                                          make_prefill_step)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")

B, S = 1, 256
TOL_LOGITS, TOL_LOSS = 1e-4, 1e-5


@functools.lru_cache(maxsize=None)
def _pair(policy, logits_chunk=512):
    kw = dict(policy=policy, use_flash=True, logits_chunk=logits_chunk)
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(**kw)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config("qwen3-4b")).replace(**kw),
                         device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S))
    labels = rng.integers(0, vocab, size=(B, S))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _routes(monkeypatch):
    """Record the name of every `flash_attn` route the port resolves."""
    seen, resolve = [], exec_plan.resolve

    def spy(op, policy=None, **ctx):
        entry = resolve(op, policy, **ctx)
        if op == "flash_attn":
            seen.append(entry.name)
        return entry
    monkeypatch.setattr(exec_plan, "resolve", spy)
    return seen


def test_prefill_f32_flash_matches_jax(monkeypatch):
    rmodel, rparams, tmodel, tparams = _pair("fp8_dpa")
    jb, tb = _batch(tmodel.cfg.vocab_size)
    want, _ = jax.jit(RSTEP.make_prefill_step(rmodel))(
        rparams, {"tokens": jb["tokens"]})
    seen = _routes(monkeypatch)
    got, caches = make_prefill_step(tmodel)(tparams, tb["tokens"])
    assert seen == ["cuda_f32_flash"] * tmodel.cfg.n_layers
    assert got.shape == (B, 1, tmodel.cfg.vocab_size)
    assert len(caches) == tmodel.cfg.n_layers
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= TOL_LOGITS, err


@pytest.mark.parametrize("logits_chunk", [512, 96])
def test_scoring_dpa_flash_matches_jax(monkeypatch, logits_chunk):
    """logits_chunk 512 -> chunk min(512, 256) divides S (chunked
    cross-entropy over backbone_features); 96 does not (train_logits +
    softmax_xent)."""
    rmodel, rparams, tmodel, tparams = _pair("w4a8_kv4_attn8", logits_chunk)
    jb, tb = _batch(tmodel.cfg.vocab_size)
    want_total, want = jax.jit(RSTEP.make_loss_fn(rmodel))(rparams, jb)
    seen = _routes(monkeypatch)
    got_total, got = make_loss_fn(tmodel)(tparams, tb)
    assert seen == ["cuda_dpa_flash"] * tmodel.cfg.n_layers
    assert float(got["aux"]) == float(want["aux"]) == 0.0
    for a, b in ((got_total, want_total), (got["loss"], want["loss"])):
        assert abs(float(a) - float(b)) <= TOL_LOSS, (float(a), float(b))
    if logits_chunk == 96:
        want_logits, _ = jax.jit(rmodel.train_logits)(rparams, jb)
        got_logits, aux = tmodel.train_logits(tparams, tb)
        assert got_logits.dtype == torch.float32 and float(aux) == 0.0
        err = float(np.abs(got_logits.numpy()
                           - np.asarray(want_logits)).max())
        assert err <= TOL_LOGITS, err


def test_use_flash_resolves_the_dpa_flash_route(monkeypatch):
    rmodel, rparams, tmodel, tparams = _pair("attn_fp8_dpa")
    jb, tb = _batch(tmodel.cfg.vocab_size, seed=1)
    want = np.asarray(jax.jit(rmodel.train_logits)(rparams, jb)[0])
    seen = _routes(monkeypatch)
    got = tmodel.train_logits(tparams, tb)[0].numpy()
    assert seen == ["cuda_dpa_flash"] * tmodel.cfg.n_layers
    err = float(np.abs(got - want).max())
    assert err <= TOL_LOGITS, err
    # the route the port took before it read use_flash: one global max
    # per row, p quantized over all S keys at once
    plain = build_model(tmodel.cfg.replace(use_flash=False), device="cpu")
    glob = plain.train_logits(tparams, tb)[0].numpy()
    assert seen[-1] == "torch_dpa_attn"
    assert float(np.abs(glob - want).max()) > 10 * TOL_LOGITS
