"""The port's checkpoints (`repro_torch.runtime.checkpoint`) and training
supervisor (`repro_torch.runtime.fault`), on the CPU, as the reference's
tests/test_checkpoint_fault.py holds the reference's.

  checkpoints   a roundtrip bit for bit (f32, int32, 0-dim leaves, a
                nested list); LATEST survives a partial `.tmp`; a shape
                mismatch raises ValueError and a missing leaf KeyError;
                `AsyncSaver` keeps step N's values after the state is
                updated in place for step N+1; the layout is the
                reference's (its `restore` reads a port checkpoint of the
                same tree).
  supervisor    replay after an injected failure (the counting step, as
                the reference's test); a reduced granite-moe-1b run under
                fp8_dpa with a failure injected equals a clean run bit
                for bit, through async and synchronous saves; the
                straggler watchdog fires; max_failures raises.
"""
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.data.pipeline import DataConfig, make_pipeline  # noqa: E402
from repro_torch.distributed.step import make_train_step  # noqa: E402
from repro_torch.launch.train import build_state  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.runtime import checkpoint as ck  # noqa: E402
from repro_torch.runtime.fault import Supervisor, SupervisorConfig  # noqa: E402,E501


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops lose
    most of their time to thread hand-offs when test workers share the
    cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn(32, 16, generator=g),
                       "layers": [{"b": torch.zeros(16)},
                                  {"b": torch.randn(16, generator=g)}]},
            "opt": {"m": {"w": torch.ones(32, 16)},
                    "count": torch.tensor(5, dtype=torch.int32)}}


def _equal(a, b):
    pa, pb = flatten_with_paths(a), flatten_with_paths(b)
    assert [p for p, _ in pa] == [p for p, _ in pb]
    return all(x.dtype == y.dtype and torch.equal(x, y)
               for (_, x), (_, y) in zip(pa, pb))


def test_save_restore_roundtrip(tmp_path):
    s = _state()
    ck.save(s, 42, str(tmp_path))
    assert ck.latest_step(str(tmp_path)) == 42
    r, step = ck.restore(str(tmp_path), s)
    assert step == 42 and _equal(r, s)
    assert r["params"]["w"] is not s["params"]["w"]
    assert r["opt"]["count"].shape == ()


def test_latest_pointer_survives_a_partial_save(tmp_path):
    s = _state()
    ck.save(s, 1, str(tmp_path))
    ck.save(s, 2, str(tmp_path))
    assert ck.latest_step(str(tmp_path)) == 2
    (tmp_path / "step_00000003.tmp").mkdir()
    assert ck.latest_step(str(tmp_path)) == 2
    assert ck.restore(str(tmp_path), s)[1] == 2


def test_restore_refuses_other_shapes_and_missing_leaves(tmp_path):
    s = _state()
    ck.save(s, 0, str(tmp_path))
    bad = {**s, "params": {**s["params"], "w": torch.zeros(3, 32, 16)}}
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(str(tmp_path), bad)
    more = {**s, "extra": torch.zeros(2)}
    with pytest.raises(KeyError, match="extra"):
        ck.restore(str(tmp_path), more)
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "none"), s)


def test_async_saver_keeps_the_saved_step(tmp_path):
    s = _state()
    want = {k: v.clone() for k, v in s["params"].items() if k == "w"}
    saver = ck.AsyncSaver()
    saver.save(s, 10, str(tmp_path))
    s["params"]["w"].add_(1.0)                 # step 11's in-place update
    s["opt"]["count"].add_(1)
    saver.join()
    r, _ = ck.restore(str(tmp_path), s)
    assert torch.equal(r["params"]["w"], want["w"])
    assert int(r["opt"]["count"]) == 5


def test_reference_restore_reads_the_port_layout(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.runtime import checkpoint as rck
    s = _state()
    ck.save(s, 7, str(tmp_path))
    target = jax.tree.map(lambda t: np.zeros(t.shape, t.numpy().dtype), s,
                          is_leaf=torch.is_tensor)
    with jax.enable_x64(False):
        r, step = rck.restore(str(tmp_path), target)
    assert step == 7
    for (_, a), (_, b) in zip(flatten_with_paths(s), flatten_with_paths(r)):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _counting_step(state, batch):
    state["n"].add_(1)
    return state, {"loss": torch.zeros(())}


def test_supervisor_replays_after_a_failure(tmp_path):
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=5,
                                      async_save=False),
                     state={"n": torch.zeros((), dtype=torch.int32)})
    sup.inject_failure_at = 12
    seen = []
    out = sup.run(_counting_step, lambda s: {"step": s}, 20,
                  on_metrics=lambda s, m, dt: seen.append(s))
    assert int(out["n"]) == 20
    assert sup.events[0][0] == "failure" and sup.events[1] == ("restored", 9)
    assert seen.count(10) == 2 and seen.count(11) == 2
    assert seen.count(12) == 1 and seen.count(9) == 1


@pytest.fixture(scope="module")
def granite_run():
    """A reduced granite-moe-1b train step under fp8_dpa with remat, its
    pipeline, and a clean 6-step run."""
    cfg = reduce_config(get_config("granite-moe-1b-a400m")).replace(
        policy="fp8_dpa", logits_chunk=8, attn_chunk=8, remat="full")
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, adamw.AdamWConfig(lr=3e-3,
                                                    warmup_steps=2,
                                                    total_steps=8))
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=2,
                                    seq=32), device="cpu")
    clean = build_state(model, 0)
    for i in range(6):
        clean, _ = step(clean, pipe.batch(i))
    return model, step, pipe, clean


@pytest.mark.parametrize("async_save", [True, False])
def test_supervised_training_with_a_failure_equals_a_clean_run(
        tmp_path, async_save, granite_run):
    model, step, pipe, clean = granite_run
    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=3,
                                      async_save=async_save),
                     state=build_state(model, 0))
    sup.inject_failure_at = 4
    faulty = sup.run(step, pipe.batch, 6)
    assert [e[0] for e in sup.events] == ["failure", "restored"]
    assert sup.events[1] == ("restored", 2)
    assert _equal(faulty, clean)


def test_supervisor_straggler_watchdog(tmp_path):
    calls = {"n": 0}

    def slow_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:
            time.sleep(1.0)                    # straggle once
        return state, {"loss": torch.zeros(())}

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path), ckpt_every=2,
                                      step_deadline_s=0.5, async_save=False),
                     state={"n": torch.zeros((), dtype=torch.int32)})
    sup.run(slow_step, lambda s: {}, 5)
    assert "failure" in [e[0] for e in sup.events]
    assert "StragglerTimeout" in sup.events[0][2]
    assert sup.failures == 1


def test_supervisor_gives_up_after_max_failures(tmp_path):
    def bad_step(state, batch):
        raise RuntimeError("always broken")

    sup = Supervisor(SupervisorConfig(ckpt_dir=str(tmp_path),
                                      max_failures=3, async_save=False),
                     state={})
    with pytest.raises(RuntimeError, match="always broken"):
        sup.run(bad_step, lambda s: {}, 5)
    assert sup.failures == 4
