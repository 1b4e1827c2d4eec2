"""The port's AdamW (`repro_torch.optim.adamw`) against the reference's
under `jax.jit`, on the same numpy params, moments and gradients.

  lr_at        every schedule (cosine, linear, constant) over steps
               0..120, warmup 7, total 93: rtol 1e-6.  The constant
               schedule is bit for bit; the others miss by an ulp where
               XLA fuses a multiply-add into one FMA (the port rounds
               twice) or its cos differs from torch's.
  update       four steps from zero moments, a tree of 2-D (decayed) and
               1-D (not decayed) leaves, the gradients above and below
               the clip norm: params, m and v at rtol 1e-6 plus an atol
               of 1e-6 times the leaf's largest magnitude (an element
               that cancels, as `0.9 m + 0.1 g` near zero, keeps the
               absolute error of its operands), grad_norm and lr at rtol
               1e-6.  XLA fuses `b m + (1-b) g` and `p - lr step` into
               FMAs, so most but not all elements are bit for bit (the
               printed share).
  clip         global_norm and clip_by_global_norm at rtol 1e-6.

Measured worst differences: lr 2.1e-7 relative (74-79 % of the steps
bit for bit under cosine and linear); params, m and v 4.4e-7 of their
leaf's largest magnitude (68-84 % of the elements bit for bit).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as RA  # noqa: E402
from repro_torch.core.tree import tree_map  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

RTOL = 1e-6
SCHEDULES = ("cosine", "linear", "constant")


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


def _cfgs(schedule, **kw):
    args = {**dict(lr=1e-3, warmup_steps=7, total_steps=93), **kw,
            "schedule": schedule}
    return RA.AdamWConfig(**args), TA.AdamWConfig(**args)


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_lr_at_matches_jit(schedule):
    rcfg, tcfg = _cfgs(schedule)
    f = jax.jit(lambda s: RA.lr_at(rcfg, s))
    steps = np.arange(0, 121, dtype=np.int32)
    want = np.array([f(jnp.int32(s)) for s in steps])
    got = np.array([TA.lr_at(tcfg, torch.tensor(int(s), dtype=torch.int32))
                    .item() for s in steps], dtype=np.float32)
    got_int = np.array([TA.lr_at(tcfg, int(s)).item() for s in steps],
                       dtype=np.float32)
    assert np.array_equal(got, got_int)
    rel = np.abs(got - want) / np.abs(want)
    print(f"{schedule}: worst rel {rel.max():.2e}, bit for bit "
          f"{np.mean(got == want):.0%}")
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if schedule == "constant":
        assert np.array_equal(got, want)


def _tree(rng, scale):
    return {"layers": [{"w": rng.normal(size=(16, 24)).astype(np.float32),
                        "scale": rng.normal(size=(16,)).astype(np.float32)}
                       for _ in range(2)],
            "embed": {"table": rng.normal(size=(40, 16)).astype(np.float32)},
            "stack": rng.normal(size=(3, 8, 5)).astype(np.float32) * scale}


def _torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pairs(jtree, ttree):
    return zip(jax.tree.leaves(jtree), jax.tree.leaves(
        ttree, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("grad_scale", [0.01, 3.0], ids=["unclipped",
                                                          "clipped"])
def test_update_matches_jit(schedule, grad_scale):
    rcfg, tcfg = _cfgs(schedule, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(0)
    params = _tree(rng, 1.0)
    jp = jax.tree.map(jnp.asarray, params)
    jo = RA.init(jp)
    tp = _torch(params)
    to = TA.init(tp)
    step = jax.jit(lambda g, o, p: RA.update(rcfg, g, o, p))
    same, total, worst = 0, 0, 0.0
    for _ in range(4):
        grads = jax.tree.map(lambda a: a * grad_scale,
                             _tree(rng, 1.0))
        jp, jo, jm = step(jax.tree.map(jnp.asarray, grads), jo, jp)
        # the reference decays the leaves of 2 dims and more
        tp_out, to_out, tm = TA.update(tcfg, _torch(grads), to, tp,
                                       tree_map(lambda p: p.ndim >= 2, tp))
        assert tp_out is tp and to_out is to            # in place
        assert int(to["count"]) == int(jo["count"])
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL)
        for jt, tt in ((jp, tp), (jo["m"], to["m"]), (jo["v"], to["v"])):
            for a, b in _pairs(jt, tt):
                a, b = np.asarray(a), b.numpy()
                scale = float(np.abs(a).max())
                np.testing.assert_allclose(b, a, rtol=RTOL,
                                           atol=RTOL * scale)
                same += int((a == b).sum())
                total += a.size
                worst = max(worst, float(np.abs(a - b).max()) / scale)
    print(f"{schedule}, x{grad_scale}: worst rel {worst:.2e}, bit for bit "
          f"{same / total:.1%}")


def test_init_mirrors_params():
    params = _torch(_tree(np.random.default_rng(1), 1.0))
    opt = TA.init(params)
    assert opt["count"].dtype == torch.int32 and opt["count"].ndim == 0
    for p, m, v in zip(*(jax.tree.leaves(t, is_leaf=torch.is_tensor)
                         for t in (params, opt["m"], opt["v"]))):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not m.any() and not v.any() and m is not v


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_jit(max_norm):
    grads = _tree(np.random.default_rng(2), 4.0)
    jg, jn = jax.jit(lambda g: RA.clip_by_global_norm(g, max_norm))(
        jax.tree.map(jnp.asarray, grads))
    tg, tn = TA.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL)
    np.testing.assert_allclose(float(TA.global_norm(_torch(grads))),
                               float(jn), rtol=RTOL)
    for a, b in _pairs(jg, tg):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
