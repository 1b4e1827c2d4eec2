"""The port's adaptive draft controller (`repro_torch.runtime.controller`)
against the reference's (`repro.runtime.controller`).

Both are pure (state, observation) -> (state, rung) functions, so seeded
acceptance traces replay through each to the same rung sequence and the
same states, exactly; the config validation, the ladders and the
controller's properties are the reference tests' (`tests/test_controller
.py`), on the port's copy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import controller as RC  # noqa: E402
from repro_torch.core.policy import POLICIES  # noqa: E402
from repro_torch.runtime import controller as C  # noqa: E402

LADDER = ("w4a4_kv4_attn4", "w4a8_kv4_attn8", "w16a16_kv4_attn16")

# (knobs, trace seed): thresholds, dwell, EMA weight and start rung spread
# over their ranges, per-rung ks included
CONFIGS = [
    (dict(), 0),
    (dict(dwell=1), 1),
    (dict(dwell=3, ema_alpha=0.3, start=0), 2),
    (dict(demote_above=0.9, promote_below=0.1, dwell=1, start=1), 3),
    (dict(ks=(4, 2, 1), dwell=2, ema_alpha=0.8), 4),
    (dict(demote_above=0.6, promote_below=0.55, dwell=1, ema_alpha=1.0), 5),
]


def _cfg(mod, **kw):
    kw.setdefault("ladder", LADDER)
    return mod.ControllerConfig(**kw)


def _trace(seed, cfg, n=60):
    """Seeded (accepted, drafted) rounds: stretches of high, low and mixed
    acceptance, drafted = the rung's k (the first rung's here)."""
    rng = np.random.default_rng(seed)
    k = cfg.rung_ks[0]
    regimes = rng.choice([0.05, 0.5, 0.95], size=n // 10)
    return [(int(rng.binomial(k, p)), k) for p in np.repeat(regimes, 10)]


@pytest.mark.parametrize("knobs,seed", CONFIGS,
                         ids=[f"cfg{i}" for i in range(len(CONFIGS))])
def test_replay_equals_jax_rungs_and_states(knobs, seed):
    cfg, rcfg = _cfg(C, **knobs), _cfg(RC, **knobs)
    trace = _trace(seed, cfg)
    assert C.replay(cfg, trace) == RC.replay(rcfg, trace)
    state, rstate = C.init_state(cfg), RC.init_state(rcfg)
    for acc, dr in trace:
        state, rung = C.step(cfg, state, acc, dr)
        rstate, rrung = RC.step(rcfg, rstate, acc, dr)
        assert rung == rrung
        assert dataclasses.asdict(state) == dataclasses.asdict(rstate)
    assert state.switches > 0 or knobs.get("dwell", 2) > 2


def test_default_ladders_equal_jax():
    assert C.DEFAULT_LADDERS == RC.DEFAULT_LADDERS
    for name, pol in POLICIES.items():
        if not pol.kv_quantized:
            with pytest.raises(ValueError, match="raw f32 cache"):
                C.default_ladder(name)
            continue
        assert C.default_ladder(name) == RC.default_ladder(name)
        for rung in C.default_ladder(name):
            rp = POLICIES[rung]
            assert (rp.fmt_kv, rp.kv_packed) == (pol.fmt_kv, pol.kv_packed)


@pytest.mark.parametrize("kw,match", [
    (dict(ladder=("w4a4_kv4_attn4", "no_such_policy")), "not a policy preset"),
    (dict(ladder=()), "at least one rung"),
    (dict(demote_above=0.4, promote_below=0.6), "promote_below < demote_above"),
    (dict(demote_above=0.5, promote_below=0.5), "promote_below < demote_above"),
    (dict(ks=(2, 3)), "entries for a"),
    (dict(ks=(2, 0, 3)), ">= 1"),
    (dict(dwell=0), "dwell"),
    (dict(ema_alpha=0.0), "ema_alpha"),
    (dict(start=3), "start rung"),
])
def test_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        _cfg(C, **kw)
    with pytest.raises(ValueError, match=match):
        _cfg(RC, **kw)


def test_rung_ks_max_k_and_start():
    assert _cfg(C, k=5).rung_ks == (5, 5, 5)
    cfg = _cfg(C, ks=(4, 2, 1))
    assert cfg.rung_ks == (4, 2, 1) and cfg.max_k == 4
    assert _cfg(C).start_rung == len(LADDER) - 1
    assert _cfg(C, start=0).start_rung == 0


def test_demote_promote_clamp_and_dwell():
    rungs = C.replay(_cfg(C, dwell=1), [(4, 4)] * 6)
    assert rungs[-1] == 0 and rungs == sorted(rungs, reverse=True)
    rungs = C.replay(_cfg(C, dwell=1, start=0), [(0, 4)] * 6)
    assert rungs[-1] == len(LADDER) - 1 and rungs == sorted(rungs)
    cfg = _cfg(C, dwell=3)
    rungs = C.replay(cfg, [(4, 4)] * 3)
    assert rungs[:2] == [cfg.start_rung] * 2
    assert rungs[2] == cfg.start_rung - 1


def test_dead_band_never_flaps_and_step_is_pure():
    cfg = _cfg(C, demote_above=0.75, promote_below=0.45, dwell=1, start=1)
    assert set(C.replay(cfg, [(2, 4), (3, 4)] * 20)) == {1}
    s0 = C.init_state(cfg)
    assert C.step(cfg, s0, 3, 4) == C.step(cfg, s0, 3, 4)
    assert s0 == C.init_state(cfg)
    with pytest.raises(Exception):
        s0.rung = 0
    with pytest.raises(ValueError, match="at least one"):
        C.step(cfg, s0, 0, 0)
