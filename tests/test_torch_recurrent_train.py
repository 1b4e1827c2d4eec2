"""Training on the recurrent families and serving the untied decoders:
the port against the JAX reference under `jax.jit`, on weights converted
from the reference's init.

  loss and gradients  reduced recurrentgemma-9b and xlstm-1.3b (untied
                      unembedding), fp32, B 2 x S 16, the cross-entropy in
                      8-token chunks: `value_and_grad(make_loss_fn)`
                      against `jax.value_and_grad(make_loss_fn)`, loss
                      rtol 1e-5 and each gradient leaf's relative norm
                      error <= 1e-4 (tests/test_torch_train.py's pins);
                      the unembed table's gradient is non-zero and the
                      embed table's only its gather's, so the loss reads
                      the untied table.
  decay mask          `Model.decay_mask` equals the reference's AdamW rule
                      (a leaf decays iff it has 2 dims or more in the
                      reference's stacked layout), mapped through
                      `convert_tree`: a scan group's 1-D leaves (norm
                      scales, lam) decay, a tail layer's do not.
  train state         `convert_state` moves m and v leaf for leaf with
                      the params, groups, tail and unembed included.
  untied decoders     reduced deepseek-67b, qwen2-72b (QKV biases, set
                      non-zero here) and dbrx-132b (MoE) under
                      w4a8_kv4_attn8: prefill logits, then 4 decode steps
                      from the prefill's caches (grown by 4 rows on both
                      sides), within 1e-4 (tests/test_torch_model.py's
                      pin), greedy tokens equal where the margin exceeds
                      2e-4.

Measured worst on these inputs: losses equal (0 relative), gradient
leaves 4.0e-6 (recurrentgemma) and 6.9e-5 (xlstm: the mLSTM's C state
sums an outer product a chunk, and its small entries carry the
frameworks' sum orders); untied decoders' logits 1.9e-7.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.distributed import step as TS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (convert_params,  # noqa: E402
                                        convert_state, convert_tree)

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")

B, S = 2, 16
LOSS_RTOL, LEAF_TOL, TOL = 1e-5, 1e-4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (many small ops);
    restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference in 32-bit JAX (another test module may have turned
    x64 on at import)."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _pair(arch, policy, **kw):
    rcfg = RCFG.reduce_config(RCFG.get_config(arch)).replace(policy=policy,
                                                            **kw)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(
        policy=policy, **kw), device="cpu")
    return rmodel, rparams, tmodel


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-1.3b"))
def test_loss_and_grads_match_jax(arch):
    rmodel, rparams, tmodel = _pair(arch, "fp32", logits_chunk=8)
    rng = np.random.default_rng(0)
    toks, labels = (rng.integers(0, 256, size=(B, S)) for _ in range(2))
    (want, _), wgrads = jax.jit(jax.value_and_grad(
        RSTEP.make_loss_fn(rmodel), has_aux=True))(
            rparams, {"tokens": jnp.asarray(toks),
                      "labels": jnp.asarray(labels)})
    (got, _), grads = TS.value_and_grad(TS.make_loss_fn(tmodel))(
        convert_params(_np(rparams), tmodel),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    wt = convert_tree(_np(wgrads), tmodel)
    for (path, a), (_, b) in zip(flatten_with_paths(grads),
                                 flatten_with_paths(wt)):
        err = float((a - b).norm() / max(float(b.norm()), 1e-30))
        assert err <= LEAF_TOL, (path, err)
    unembed = grads["unembed"]["table"]
    assert float(unembed.abs().max()) > 0
    # the embed table's gradient lives on the input tokens' rows only
    rows = torch.zeros(256, dtype=torch.bool)
    rows[torch.from_numpy(toks).flatten()] = True
    assert float(grads["embed"]["table"][~rows].abs().max()) == 0.0


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-1.3b",
                                  "qwen3-4b"))
def test_decay_mask_matches_reference_rule(arch):
    rmodel, rparams, tmodel = _pair(arch, "fp32")
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2, np.float32),
                        rparams)
    want = convert_tree(rule, tmodel)
    params = convert_params(_np(rparams), tmodel)
    got = tmodel.decay_mask(params)
    for (path, g), (_, w) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want)):
        assert g == bool(w.flatten()[0]), path
    if arch == "recurrentgemma-9b":      # 1 group of 3, then a tail rg
        assert got["layers"][0]["rg"]["lam"] and \
            got["layers"][0]["norm1"]["scale"]
        assert not got["layers"][3]["rg"]["lam"]
        assert not got["layers"][3]["norm1"]["scale"]
        assert got["layers"][3]["rg"]["conv"] and not got["norm_f"]["scale"]
    if arch == "xlstm-1.3b":             # 1 group of 8, then a tail mLSTM
        assert got["layers"][7]["norm1"]["scale"]
        assert not got["layers"][8]["norm1"]["scale"]


def _grow_ref(rc, extra):
    """The reference's prefill caches with `extra` zero rows appended on
    the sequence axis (axis 2 of a scan group's leaves, 1 of a tail's)."""
    def pad(a, axis):
        widths = [(0, 0)] * a.ndim
        widths[axis] = (0, extra)
        return jnp.pad(a, widths)
    return {"groups": jax.tree.map(lambda a: pad(a, 2), rc["groups"]),
            "tail": [jax.tree.map(lambda a: pad(a, 1), t) for t in rc["tail"]]}


def _grow_port(caches, extra):
    return [{k: torch.cat([v, torch.zeros((v.shape[0], extra) + v.shape[2:],
                                          dtype=v.dtype)], dim=1)
             for k, v in c.items()} for c in caches]


def _check(got, want):
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * TOL
    assert np.all((np.argmax(got, -1) == np.argmax(want, -1))[decisive])


@pytest.mark.parametrize("arch", ("deepseek-67b", "qwen2-72b", "dbrx-132b"))
def test_untied_decoders_match_jax(arch):
    rmodel, rparams, tmodel = _pair(arch, "w4a8_kv4_attn8")
    assert not tmodel.cfg.tie_embeddings
    rng = np.random.default_rng(1)
    rparams = jax.tree_util.tree_map_with_path(
        lambda path, a: (jnp.asarray(rng.standard_normal(a.shape) * 0.1,
                                     a.dtype)
                         if path[-1] == jax.tree_util.DictKey("b") else a),
        rparams)
    n_bias = sum(1 for p, _ in jax.tree_util.tree_flatten_with_path(
        rparams)[0] if p[-1] == jax.tree_util.DictKey("b"))
    assert n_bias == (3 if tmodel.cfg.qkv_bias else 0)
    tparams = convert_params(_np(rparams), tmodel)
    toks = rng.integers(0, 256, size=(B, 12 + 4))
    want, rc = jax.jit(rmodel.prefill)(rparams,
                                       {"tokens": jnp.asarray(toks[:, :12])})
    got, caches = tmodel.prefill(tparams, torch.from_numpy(toks[:, :12]))
    _check(got.numpy(), np.asarray(want))
    rc, caches = _grow_ref(rc, 4), _grow_port(caches, 4)
    step = jax.jit(rmodel.decode_step)
    for t in range(12, 16):
        want, rc = step(rparams, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                  "index": jnp.int32(t)}, rc)
        got, caches = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                      "index": t}, caches)
        _check(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-1.3b"))
def test_convert_state_unstacks_groups_and_tail(arch):
    """A reference train state crosses leaf for leaf: m and v (here 2x and
    3x the params) land where the params do, tail and unembed included."""
    _, rparams, tmodel = _pair(arch, "fp32")
    state = {"params": _np(rparams),
             "opt": {"m": jax.tree.map(lambda a: np.asarray(a) * 2, rparams),
                     "v": jax.tree.map(lambda a: np.asarray(a) * 3, rparams),
                     "count": np.int32(5)}}
    got = convert_state(state, tmodel)
    for key, k in (("m", 2.0), ("v", 3.0)):
        for (path, a), (_, p) in zip(flatten_with_paths(got["opt"][key]),
                                     flatten_with_paths(got["params"])):
            assert torch.equal(a, p * k), (key, path)
    assert int(got["opt"]["count"]) == 5
    assert "unembed" in got["params"] and \
        len(got["params"]["layers"]) == tmodel.cfg.n_layers
