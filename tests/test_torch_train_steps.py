"""Train steps of the port against the reference's jitted `make_train_step`
on reduced qwen3-4b, llama3.2-3b and granite-moe-1b, and a train state
carried across from a checkpoint the reference wrote.

  five train steps   from one converted state, on the reference
                     pipeline's batches (B 2 x S 32, 8-token cross-entropy
                     chunks and 8-query attention blocks): losses per step
                     rtol 1e-4 (fp32) / 1e-3 (fp8_dpa), the final params'
                     leaves at relative norm 1e-3 / 1e-2.  AdamW's decay
                     follows the reference's stacked layout
                     (`Model.decay_mask`): each layer's norm scales decay.
  carried state      the reference's `runtime.checkpoint.save` after 3 JAX
                     steps, read by `models.convert.load_reference_checkpoint`
                     without JAX; the port's 4th step against the
                     reference's 4th at the same tolerances.

Measured worst: fp32 losses 1.7e-7, params 1.6e-5; fp8_dpa losses 4.9e-4
and params 4.4e-3 (granite, where an STE code or an expert's capacity cut
flips at step 4; 8.8e-8 and 1.1e-5 for the dense models).
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.distributed import step as TS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (convert_params,  # noqa: E402
                                        convert_tree,
                                        load_reference_checkpoint)
from repro_torch.optim import adamw  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")
RADAMW = importlib.import_module("repro.optim.adamw")
RDATA = importlib.import_module("repro.data.pipeline")
RCKPT = importlib.import_module("repro.runtime.checkpoint")

ARCHS = ("qwen3-4b", "llama3.2-3b", "granite-moe-1b-a400m")
B, S = 2, 32
TOL = {"fp32": dict(loss=1e-4, leaf=1e-3),
       "fp8_dpa": dict(loss=1e-3, leaf=1e-2)}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


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
    """The reference under 32-bit JAX, its training setting: a module
    imported earlier in the same process may have turned x64 on
    (`repro.core.dpa` does on import)."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _setup(arch, policy):
    kw = dict(policy=policy, logits_chunk=8, attn_chunk=8)
    rmodel = RMODELS.build_model(
        RCFG.reduce_config(RCFG.get_config(arch)).replace(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(**kw),
                         device="cpu")
    rstep = jax.jit(RSTEP.make_train_step(rmodel, RADAMW.AdamWConfig(**OPT)))
    return rmodel, rparams, tmodel, rstep


def _batches(vocab, n):
    pipe = RDATA.make_pipeline(RDATA.DataConfig(vocab_size=vocab, batch=B,
                                                seq=S, seed=0))
    out = []
    for i in range(n):
        b = pipe.batch(i)
        out.append((b, {k: torch.from_numpy(np.asarray(v).astype(np.int64))
                        for k, v in b.items()}))
    return out


def _worst_leaf(got, want_np, tmodel):
    want = convert_tree(want_np, tmodel)
    errs = {}
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want)):
        a = a.detach()
        errs[path] = float((a - b).norm() / max(float(b.norm()), 1e-30))
    worst = max(errs, key=errs.get)
    return worst, errs[worst]


def _loss_err(tm, rm, tol):
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=tol["loss"])
    np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]), rtol=1e-6)
    return abs(float(tm["loss"]) / float(rm["loss"]) - 1)


@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_five_train_steps_match_jax(arch, policy):
    rmodel, rparams, tmodel, rstep = _setup(arch, policy)
    tstep = TS.make_train_step(tmodel, adamw.AdamWConfig(**OPT))
    rstate = {"params": rparams, "opt": RADAMW.init(rparams)}
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    tstate = {"params": tparams, "opt": adamw.init(tparams)}
    tol, worst_loss = TOL[policy], 0.0
    for jb, tb in _batches(tmodel.cfg.vocab_size, 5):
        rstate, rm = rstep(rstate, jb)
        tstate, tm = tstep(tstate, tb)
        worst_loss = max(worst_loss, _loss_err(tm, rm, tol))
    assert int(tstate["opt"]["count"]) == 5
    path, err = _worst_leaf(tstate["params"],
                            jax.tree.map(np.asarray, rstate["params"]),
                            tmodel)
    print(f"{arch} {policy}: worst loss {worst_loss:.1e}, worst param leaf "
          f"{err:.1e} at {'.'.join(path)}")
    assert err <= tol["leaf"], path


def test_decay_mask_follows_the_stacked_layout():
    model = build_model(reduce_config(get_config("qwen3-4b")), device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mask = dict((".".join(p), f) for p, f in flatten_with_paths(
        model.decay_mask(params)))
    assert mask["layers.0.norm1.scale"] and mask["layers.1.attn.q_norm.scale"]
    assert mask["layers.0.attn.wq.w"] and mask["embed.table"]
    assert not mask["norm_f.scale"]


@pytest.mark.parametrize("policy", list(TOL))
def test_state_carried_from_a_reference_checkpoint(tmp_path, policy):
    arch = "granite-moe-1b-a400m"
    rmodel, rparams, tmodel, rstep = _setup(arch, policy)
    batches = _batches(tmodel.cfg.vocab_size, 4)
    rstate = {"params": rparams, "opt": RADAMW.init(rparams)}
    for jb, _ in batches[:3]:
        rstate, _ = rstep(rstate, jb)
    RCKPT.save(rstate, 2, str(tmp_path))
    tstate, step = load_reference_checkpoint(str(tmp_path), tmodel)
    assert step == 2 and int(tstate["opt"]["count"]) == 3
    path, err = _worst_leaf(tstate["opt"]["v"],
                            jax.tree.map(np.asarray, rstate["opt"]["v"]),
                            tmodel)
    assert err == 0.0, path
    jb, tb = batches[3]
    rstate, rm = rstep(rstate, jb)
    tstate, tm = TS.make_train_step(tmodel, adamw.AdamWConfig(**OPT))(
        tstate, tb)
    loss_err = _loss_err(tm, rm, TOL[policy])
    path, err = _worst_leaf(tstate["params"],
                            jax.tree.map(np.asarray, rstate["params"]),
                            tmodel)
    print(f"{policy}: step 4 loss {loss_err:.1e}, worst param leaf "
          f"{err:.1e} at {'.'.join(path)}")
    assert err <= TOL[policy]["leaf"], path
