"""Reduced granite-moe-1b-a400m: the port's MoE layer, model and engine vs
the JAX reference.

`apply_moe` gets the same numpy inputs and the reference's own params on
both sides (f32 reduced config: d 64, 8 experts, top-2) under three
policies — the f32 route (`fp32`), the grouped fused kernel route
(`w4a8_kv4_attn8`) and the grouped prequant route (`fp4_dpa_packed`) —
at the published capacity factor and at a tight one that drops
assignments.  Routing agrees exactly (same experts, same capacity slots),
so the outputs differ only where the expert matmuls' f32 sums differ in
order: measured worst |port - reference| 1.1e-6 under fp32 and 2.4e-7
under the two kernel routes, on outputs of magnitude ~2, and 1.9e-9 on
the aux loss; the pin is 1e-5 for both.  (Worst logit error over prefill
and 12 decode steps: 5.5e-7.)  With bf16 x, through the two kernel
routes, the outputs are held to bf16 rounding: at most 1% may differ,
each by one bf16 ulp (measured: none differ).

Prefill and stepped-decode logits (the latter with the index as an int
and as a 0-dim int32 tensor) are held to `tests/test_torch_model.py`'s
rule: 1e-4 absolute, and greedy tokens agree wherever the reference's
top-1/top-2 margin exceeds twice that.  The port's MoE engine is pinned
in `tests/test_torch_moe_engine.py`.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.linear import prepare_grouped_linear  # noqa: E402
from repro_torch.models import build_model, layers as TL  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RL = importlib.import_module("repro.models.layers")
RMODELS = importlib.import_module("repro.models")

NAME = "granite-moe-1b-a400m"
POLICIES = ["fp32", "w4a8_kv4_attn8", "fp4_dpa_packed"]
MOE_TOL = 1e-5
TOL = 1e-4
B, S = 2, 12


def _cfgs(policy, **kw):
    rcfg = RCFG.reduce_config(RCFG.get_config(NAME)).replace(policy=policy,
                                                             **kw)
    tcfg = reduce_config(get_config(NAME)).replace(policy=policy, **kw)
    return rcfg, tcfg


def _moe_params(rp, policy):
    """The reference's MoE params as the port's (f32 masters), prepared for
    the policy's grouped route."""
    tp = {k: {"w": torch.from_numpy(np.array(v["w"]))} for k, v in
          rp.items()}
    if policy != "fp32":
        for name in ("wg", "wu", "wd"):
            prepare_grouped_linear(tp[name], policy)
    return tp


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_apply_moe_matches_jax(policy, cf):
    rcfg, tcfg = _cfgs(policy, capacity_factor=cf)
    rp = RL.init_moe(jax.random.PRNGKey(1), rcfg)
    x = np.random.default_rng(2).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, v: RL.apply_moe(p, v, rcfg))(
        rp, jnp.asarray(x))
    y, aux = TL.apply_moe(_moe_params(rp, policy), torch.from_numpy(x), tcfg)
    assert y.dtype == torch.float32 and y.shape == (B, S, rcfg.d_model)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=0,
                               atol=MOE_TOL)
    assert abs(float(aux) - float(want_aux)) <= MOE_TOL


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significand bits), for normal v."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 2.0 ** -126)))
    return 2.0 ** (e - 7)


@pytest.mark.parametrize("policy", POLICIES[1:])
@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("top_k", [2, 4])
def test_apply_moe_bf16_matches_jax(policy, cf, top_k):
    """bf16 x, the full-width serving dtype, through both kernel routes
    (the reference's `fp32` route cannot run a bf16 dot on the XLA CPU).
    Both sides scatter-add the dispatch buffer in bf16, round each
    weighted expert output to bf16 and sum a token's outputs in ascending
    expert order, so the bf16 result is the same bits wherever the f32
    values before each rounding agree; top-k 4 makes the summation order
    matter.  The pin follows from bf16 rounding: an f32 sum the two sides
    order differently (the activation quantize and silu are elementwise,
    the fp4 x fp4 sums exact) can move a value across a rounding midpoint,
    so at most 1% of outputs may differ, each by at most one bf16 ulp.
    Measured: 0 outputs differ.  A combine summed in descending expert
    order, or summed in f32 and rounded once, changes 20-45% of them."""
    rcfg, tcfg = _cfgs(policy, capacity_factor=cf, top_k=top_k,
                       dtype="bfloat16")
    rp = RL.init_moe(jax.random.PRNGKey(1), rcfg)
    x = np.random.default_rng(2).standard_normal(
        (B, S, rcfg.d_model)).astype(np.float32)
    want_y, want_aux = jax.jit(lambda p, v: RL.apply_moe(p, v, rcfg))(
        rp, jnp.asarray(x).astype(jnp.bfloat16))
    y, aux = TL.apply_moe(_moe_params(rp, policy),
                          torch.from_numpy(x).to(torch.bfloat16), tcfg)
    assert y.dtype == torch.bfloat16 and y.shape == (B, S, rcfg.d_model)
    got, want = y.float().numpy(), np.asarray(want_y.astype(jnp.float32))
    differ = got != want
    assert differ.sum() <= 0.01 * got.size, int(differ.sum())
    assert np.all(np.abs(got - want)[differ] <= _bf16_ulp(want[differ]))
    assert abs(float(aux) - float(want_aux)) <= MOE_TOL


def test_tight_capacity_drops_assignments():
    """At cf 0.5 some assignments overflow their expert's capacity: those
    tokens lose that expert's contribution (the test above holds the port
    to the reference there), and a token whose every assignment dropped
    comes out exactly 0."""
    _, tcfg = _cfgs("fp32", capacity_factor=0.5)
    E, K = tcfg.n_experts, tcfg.top_k
    C = int(0.5 * S * K / E) + 1
    params = TL.init_moe(torch.Generator().manual_seed(0), tcfg)
    # every token routes to experts 0 and 1: only C of S tokens fit
    params["router"]["w"].zero_()
    x = torch.randn((1, S, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    y, _ = TL.apply_moe(params, x, tcfg)
    # uniform probs: top-2 = experts 0, 1 for every token (lower index
    # first on ties); tokens 0..C-1 fit, the rest drop both assignments
    assert torch.count_nonzero(y[0, :C].abs().sum(-1)) == C
    assert torch.equal(y[0, C:], torch.zeros_like(y[0, C:]))


@functools.lru_cache(maxsize=None)
def _pair(policy):
    rcfg, tcfg = _cfgs(policy)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(tcfg, device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def _check(got, want):
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * TOL
    agree = np.argmax(got, -1) == np.argmax(want, -1)
    assert np.all(agree[decisive])


def _tokens(vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


@pytest.mark.parametrize("policy", POLICIES)
def test_prefill_logits_match_jax(policy):
    rmodel, rparams, tmodel, tparams = _pair(policy)
    toks = _tokens(tmodel.cfg.vocab_size, 0)
    want, _ = jax.jit(rmodel.prefill)(rparams, {"tokens": jnp.asarray(toks)})
    got, _ = tmodel.prefill(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (B, 1, 256)
    _check(got.numpy(), np.asarray(want))


@functools.lru_cache(maxsize=None)
def _ref_stepped(policy):
    """The reference's jitted decode_step over S tokens: logits per step."""
    rmodel, rparams, _, _ = _pair(policy)
    toks = _tokens(rmodel.cfg.vocab_size, 1)
    step = jax.jit(rmodel.decode_step)
    rc, out = rmodel.init_caches(B, 16), []
    for t in range(S):
        want, rc = step(rparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "index": jnp.int32(t)}, rc)
        out.append(np.asarray(want))
    return toks, out


# the index as a Python int, and as the 0-dim int32 tensor a captured
# step reads from its buffer (the int cases keep their ids)
INDEX_CASES = [(p, "int") for p in POLICIES] + \
    [(p, "tensor") for p in POLICIES]


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
        _check(got.numpy(), want)


def test_converter_carries_expert_stacks_and_router():
    rmodel, rparams, tmodel, tparams = _pair("w4a8_kv4_attn8")
    g = rparams["stack"]["groups"]["p0"]["mlp"]
    E, d, f = tmodel.cfg.n_experts, tmodel.cfg.d_model, tmodel.cfg.d_ff
    for i, lp in enumerate(tparams["layers"]):
        mlp = lp["mlp"]
        np.testing.assert_array_equal(mlp["router"]["w"].numpy(),
                                      np.asarray(g["router"]["w"][i]))
        np.testing.assert_array_equal(mlp["wd"]["w"].numpy(),
                                      np.asarray(g["wd"]["w"][i]))
        assert mlp["wg"]["w"].dtype == torch.float32
        assert tuple(mlp["wg"]["w"].shape) == (E, d, f)
        # load-time expert codes beside the masters; the router stays f32
        assert mlp["wg"]["wq"].dtype == torch.uint8
        assert tuple(mlp["wd"]["sw"].shape) == (E, 1, 128)
        assert set(mlp["router"]) == {"w"}
