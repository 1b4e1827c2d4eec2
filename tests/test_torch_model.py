"""Reduced qwen3-4b: the port's decoder vs the JAX reference.

Weights cross through `repro_torch.models.convert` (the port's init
draws other weights).  Prefill logits and stepped-decode logits are held
against `jax.jit` of the reference's `prefill` / `decode_step` (its
Pallas matmul kernel in interpret mode), per policy; the stepped decode
also with the index as a 0-dim int32 tensor (a captured step's buffer):

  fp32              tight: 1e-4 absolute (f32 everywhere; sum orders
                    and XLA's rsqrt/exp ulps only)
  kv4_attn8_packed  quantized attention and KV cache, f32 linears
  w4a8_kv4_attn8    adds fp4 weights x in-kernel fp8 activations

For the two quantized policies a cross-framework ulp can move a value
across an E4M3 / E2M1 rounding midpoint, and one flipped code moves a
logit by far more than an ulp.  Measured worst |port - reference| on
these inputs (prefill and 12 decode steps, logits of magnitude ~0.5):
fp32 4.5e-7, kv4_attn8_packed 3.3e-7, w4a8_kv4_attn8 1.8e-7 — no code
flipped.  The pin is 1e-4 for all three: ~300x the measured ulp noise,
and below what a flipped code moves.  Greedy tokens must agree wherever
the reference's top-1/top-2 margin exceeds twice the tolerance.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")

TOL = {"fp32": 1e-4, "kv4_attn8_packed": 1e-4, "w4a8_kv4_attn8": 1e-4}
B, S = 2, 12


@functools.lru_cache(maxsize=None)
def _pair(policy):
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(
        policy=policy)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tcfg = reduce_config(get_config("qwen3-4b")).replace(policy=policy)
    tmodel = build_model(tcfg, device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def _tokens(vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


def _check(policy, got, want):
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL[policy], (policy, err)
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * TOL[policy]
    agree = np.argmax(got, -1) == np.argmax(want, -1)
    assert np.all(agree[decisive]), policy
    return err


@pytest.mark.parametrize("policy", list(TOL))
def test_prefill_logits_match_jax(policy):
    rmodel, rparams, tmodel, tparams = _pair(policy)
    toks = _tokens(tmodel.cfg.vocab_size)
    want, _ = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(toks)})
    got, caches = tmodel.prefill(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, 1, 256)
    assert len(caches) == tmodel.cfg.n_layers
    _check(policy, got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _ref_stepped(policy):
    """The reference's jitted decode_step over S tokens: logits per step."""
    rmodel, rparams, _, _ = _pair(policy)
    toks = _tokens(rmodel.cfg.vocab_size, seed=1)
    step = jax.jit(rmodel.decode_step)
    rc, out = rmodel.init_caches(B, 16), []
    for t in range(S):
        want, rc = step(rparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "index": jnp.int32(t)}, rc)
        out.append(np.asarray(want))
    return toks, out


# the index as a Python int, and as the 0-dim int32 tensor a captured
# step reads from its buffer (the int cases keep their ids)
INDEX_CASES = [(p, "int") for p in TOL] + [(p, "tensor") for p in TOL]


@pytest.mark.parametrize("policy,index", INDEX_CASES,
                         ids=[p if i == "int" else f"{p}-tensor"
                              for p, i in INDEX_CASES])
def test_stepped_decode_logits_match_jax(policy, index):
    _, _, tmodel, tparams = _pair(policy)
    toks, wants = _ref_stepped(policy)
    tc = tmodel.init_caches(B, 16)
    for t, want in enumerate(wants):
        idx = t if index == "int" else torch.tensor(t, dtype=torch.int32)
        got, tc = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                      "index": idx}, tc)
        _check(policy, got.numpy(), want)


def test_converter_unstacks_layers():
    rmodel, rparams, tmodel, tparams = _pair("w4a8_kv4_attn8")
    g = rparams["stack"]["groups"]["p0"]
    assert len(tparams["layers"]) == tmodel.cfg.n_layers
    for i, lp in enumerate(tparams["layers"]):
        np.testing.assert_array_equal(
            lp["attn"]["wq"]["w"].numpy(),
            np.asarray(g["attn"]["wq"]["w"][i]))
        # the fused policy's load-time weights sit beside the master
        assert lp["mlp"]["wd"]["wq"].dtype == torch.uint8
        assert lp["mlp"]["wd"]["sw"].shape == (1, 128)


def test_port_init_shapes_and_scales():
    cfg = reduce_config(get_config("qwen3-4b")).replace(policy="fp32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, rparams, _, _ = _pair("fp32")
    g = rparams["stack"]["groups"]["p0"]
    lp = params["layers"][0]
    for blk, name in (("attn", "wq"), ("attn", "wo"), ("mlp", "wd")):
        w = lp[blk][name]["w"]
        assert tuple(w.shape) == g[blk][name]["w"].shape[1:]
        assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.1
    assert torch.equal(lp["norm1"]["scale"], torch.ones(cfg.d_model))
    assert abs(float(params["embed"]["table"].std()) - 0.02) < 0.002
