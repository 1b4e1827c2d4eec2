"""The port's sampler against the reference's (`repro.serving.sampler`).

The port carries its own copy of JAX's threefry arithmetic
(`repro_torch.serving.threefry`), so it draws from the reference's own
streams.  Held at tolerance 0: `PRNGKey` (seeds 0, 1, 7, 2^31 - 1, a
negative one and one past 2^32, as 32-bit JAX takes a Python int),
`fold_in`, `request_key` over rids, positions up to 2^20 and all four
roles, `random_bits`, `uniform` and `accept_uniforms`.  `gumbel` goes
through `log`, whose last bit differs between XLA and torch: within 2
ulp of max(|g|, 1) (near g = 0 the outer log cancels).  `filter_logits`
keeps the same set as the jitted reference with values within 1 ulp, on
random rows and on `tests/test_sampler.py`'s
edge cases (ties at the k-th value, top-p exactly on a cumulative step,
k >= V, all-NaN rows, all masked but one).  `sample_tokens` equals
`jax.vmap(jax.random.categorical)` on every row whose reference margin
(top-1 minus top-2 of gumbel + filtered logits) exceeds 8 ulp of its top
value, and at least 60 of 64 rows must qualify (V 256 and 151,936).
Temperature 0 is `greedy_tokens` bit for bit.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.serving import sampler as TS  # noqa: E402
from repro_torch.serving import threefry as TF  # noqa: E402

RS = importlib.import_module("repro.serving.sampler")

SEEDS = (0, 1, 7, 2**31 - 1, -3)
RIDS = (0, 1, 5, 1000, 2**31 - 1)
POSITIONS = (0, 1, 17, 4095, 2**20)
ROLES = (TS.ROLE_SAMPLE, TS.ROLE_DRAFT, TS.ROLE_ACCEPT, TS.ROLE_RESIDUAL)


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference under 32-bit JAX, its serving setting: a module
    imported earlier in the same process may have turned x64 on
    (`repro.core.dpa` does on import)."""
    with jax.enable_x64(False):
        yield


def _grid():
    r, p = np.meshgrid(np.asarray(RIDS, np.int32),
                       np.asarray(POSITIONS, np.int32), indexing="ij")
    return r.ravel(), p.ravel()


def _ref_keys(seed, rids, positions, role):
    return np.asarray(jax.vmap(
        lambda r, p: RS.request_key(seed, r, p, role))(
            jnp.asarray(rids), jnp.asarray(positions))).astype(np.int64)


def _logits(seed, b, v, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((b, v))
            * scale).astype(np.float32)


def _cfgs(**kw):
    return RS.SamplerConfig(**kw), TS.SamplerConfig(**kw)


@functools.lru_cache(maxsize=None)
def _ref_filter(temperature, top_k, top_p):
    cfg = RS.SamplerConfig(temperature=temperature, top_k=top_k, top_p=top_p)
    return jax.jit(lambda x: RS.filter_logits(x, cfg))


def _filter_both(x, **kw):
    kw = dict(dict(temperature=0.0, top_k=0, top_p=1.0), **kw)
    want = np.asarray(_ref_filter(kw["temperature"], kw["top_k"],
                                  kw["top_p"])(x))
    got = TS.filter_logits(torch.from_numpy(x), TS.SamplerConfig(**kw))
    return got.numpy(), want


def _same_filter(got, want):
    """The same kept set, kept values within 1 ulp."""
    kept = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), kept)
    assert np.all(got[~kept] == -np.inf)
    ulp = np.spacing(np.abs(want[kept]))
    assert np.all(np.abs(got[kept] - want[kept]) <= ulp)


# -----------------------------------------------------------------------------
# the streams: tolerance 0
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS + (2**32 + 5,))
def test_prng_key_and_fold_in_equal_jax(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    key = TF.prng_key(seed)
    assert key.dtype == torch.int64
    assert np.array_equal(key.numpy(), want)
    for data in (0, 3, 65, 2**20, 2**31 - 1, 2**32 - 1):
        ref = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
        assert np.array_equal(TF.fold_in(key, data).numpy(),
                              ref.astype(np.int64)), data


def test_a_known_key_pinned():
    """fold_in(fold_in(fold_in(PRNGKey(7), 3), 65), 0) on both sides."""
    key = TS.request_key(7, 3, 65, 0)
    assert key.tolist() == [2112528985, 2251891203]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("role", ROLES)
def test_request_key_equals_jax(seed, role):
    rids, positions = _grid()
    want = _ref_keys(seed, rids, positions, role)
    got = TS.request_key(seed, torch.from_numpy(rids),
                         torch.from_numpy(positions), role)
    assert got.shape == (len(rids), 2)
    assert np.array_equal(got.numpy(), want)
    # Python ints fold on the host to the same key
    for i in (0, 7, len(rids) - 1):
        one = TS.request_key(seed, int(rids[i]), int(positions[i]), role)
        assert np.array_equal(one.numpy(), want[i])


@pytest.mark.parametrize("n", [1, 7, 1000, 151936])
def test_random_bits_and_uniform_equal_jax(n):
    rids, positions = _grid()
    keys = TS.request_key(5, torch.from_numpy(rids[:3]),
                          torch.from_numpy(positions[:3]), TS.ROLE_SAMPLE)
    ref_keys = jnp.asarray(keys.numpy().astype(np.uint32))
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(ref_keys)
    got = TF.random_bits(keys, n)
    assert np.array_equal(got.numpy(), np.asarray(bits).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                   (-2.5, 3.0)):
        want = np.asarray(jax.vmap(
            lambda k: jax.random.uniform(k, (n,), minval=lo, maxval=hi))(
                ref_keys))
        u = TF.uniform(keys, n, lo, hi)
        assert u.dtype == torch.float32
        assert np.array_equal(u.numpy(), want), (lo, hi)


@pytest.mark.parametrize("seed", SEEDS)
def test_accept_uniforms_equal_jax(seed):
    rids, positions = _grid()
    rcfg, tcfg = _cfgs(temperature=1.0, seed=seed)
    want = np.asarray(RS.accept_uniforms(jnp.asarray(rids),
                                         jnp.asarray(positions), rcfg))
    got = TS.accept_uniforms(torch.from_numpy(rids),
                             torch.from_numpy(positions), tcfg)
    assert got.dtype == torch.float32 and got.shape == (len(rids),)
    assert np.array_equal(got.numpy(), want)
    assert np.all((want >= 0) & (want < 1))


@pytest.mark.parametrize("n", [256, 151936])
def test_gumbel_within_two_ulp(n):
    keys = TS.request_key(11, torch.arange(4), torch.full((4,), 9),
                          TS.ROLE_SAMPLE)
    ref_keys = jnp.asarray(keys.numpy().astype(np.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,)))(
        ref_keys))
    got = TF.gumbel(keys, n).numpy()
    assert np.all(np.isfinite(got))
    # ulps of max(|g|, 1): near g = 0 the outer log cancels, and the inner
    # log's last bit shows as an absolute error of ~2^-24
    ulp = np.spacing(np.maximum(np.abs(want), 1.0))
    assert np.all(np.abs(got - want) <= 2 * ulp)


# -----------------------------------------------------------------------------
# filter_logits: the same set, values within 1 ulp
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(temperature=0.8, top_k=20, top_p=0.9),
    dict(temperature=0.7, top_k=16, top_p=0.95),
    dict(temperature=1.0),
    dict(temperature=0.8, top_p=0.5),
    dict(temperature=1.3, top_k=5),
    dict(temperature=0.0, top_k=3)])
def test_filter_logits_random_rows(kw):
    got, want = _filter_both(_logits(1, 16, 256), **kw)
    _same_filter(got, want)


def test_filter_top_k_ties_at_kth_value_all_kept():
    x = np.asarray([[4.0, 3.0, 3.0, 1.0, 0.0],
                    [2.0, 2.0, 2.0, 2.0, -1.0]], np.float32)
    for k in (1, 2, 3):
        got, want = _filter_both(x, temperature=1.0, top_k=k)
        _same_filter(got, want)
    got, _ = _filter_both(x, temperature=1.0, top_k=2)
    assert np.isfinite(got).sum(-1).tolist() == [3, 4]   # ties kept


def test_filter_top_p_exactly_on_a_cumulative_step():
    """Equal logits give exactly representable probabilities (1/4, 1/8):
    top-p lands exactly on a cumulative step, and the reference's rule
    (mass strictly before < p; every token at the threshold kept) gives
    the same set on both sides; also the reference test's (.5, .3, .2)."""
    x = np.full((3, 8), -np.inf, np.float32)
    x[0, :4] = 0.0                      # four at 1/4
    x[1, :2] = 0.0                      # two at 1/3 ...
    x[1, 2:4] = np.log(np.float32(0.5))   # ... two at 1/6
    x[2, :8] = 0.0                      # eight at 1/8
    for p in (0.25, 0.5, 0.75, 0.125, 0.375):
        got, want = _filter_both(x, temperature=1.0, top_p=p)
        _same_filter(got, want)
    y = np.log(np.asarray([[0.5, 0.3, 0.2]], np.float32))
    for p in (0.8, 0.81, 0.5, 0.3):
        got, want = _filter_both(y, temperature=1.0, top_p=p)
        _same_filter(got, want)
    got, _ = _filter_both(y, temperature=1.0, top_p=0.8)
    assert np.isfinite(got[0]).tolist() == [True, True, False]


def test_filter_k_at_or_above_vocab_disables():
    x = _logits(7, 3, 16)
    off, _ = _filter_both(x, temperature=1.0)
    for k in (16, 17, 1000):
        got, want = _filter_both(x, temperature=1.0, top_k=k)
        _same_filter(got, want)
        assert np.array_equal(got, off)


def test_filter_all_nan_and_all_masked_but_one():
    rows = np.stack([np.full(8, np.nan), np.full(8, -np.inf),
                     np.asarray([-np.inf, np.nan, 2.5, -np.inf, np.nan,
                                 -np.inf, -np.inf, -np.inf]),
                     np.zeros(8)]).astype(np.float32)
    rows[3, 5] = 3.0
    for kw in (dict(temperature=1.0), dict(temperature=0.7, top_k=4,
                                           top_p=0.9),
               dict(temperature=1.0, top_p=0.5), dict(temperature=0.0)):
        got, want = _filter_both(rows, **kw)
        _same_filter(got, want)
        assert got[0, 0] == 0.0 and got[1, 0] == 0.0
        assert np.isfinite(got[2]).tolist() == [False, False, True] + [
            False] * 5
        probs = TS.sample_probs(torch.from_numpy(rows),
                                TS.SamplerConfig(**kw)).numpy()
        assert np.all(np.isfinite(probs))
    for kw in (dict(), dict(temperature=1.0, seed=2),
               dict(temperature=0.5, top_k=3, top_p=0.9)):
        toks = TS.sample_tokens(torch.from_numpy(rows), torch.zeros(4),
                                torch.zeros(4), TS.SamplerConfig(**kw))
        assert toks.tolist()[:3] == [0, 0, 2], kw


# -----------------------------------------------------------------------------
# the draws
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("v", [256, 151936])
@pytest.mark.parametrize("kw", [dict(temperature=0.8, top_k=50, top_p=0.95),
                                dict(temperature=1.0)])
def test_sample_tokens_equal_jax_categorical(v, kw):
    b = 64
    x = _logits(v, b, v, scale=2.0)
    rids = np.arange(b, dtype=np.int32) * 7 + 1
    positions = (np.arange(b, dtype=np.int32) * 131 + 5) % (2**20)
    rcfg, tcfg = _cfgs(seed=7, **kw)
    keys = jax.vmap(lambda r, p: RS.request_key(7, r, p, RS.ROLE_SAMPLE))(
        jnp.asarray(rids), jnp.asarray(positions))
    filt = _ref_filter(rcfg.temperature, rcfg.top_k, rcfg.top_p)(x)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, filt))
    z = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (v,)))(keys)
                   + filt)
    top2 = np.sort(z, axis=-1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 8 * np.spacing(
        np.abs(top2[:, 1]))
    assert decisive.sum() >= 60
    got = TS.sample_tokens(torch.from_numpy(x), torch.from_numpy(rids),
                           torch.from_numpy(positions), tcfg)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy()[decisive], want[decisive])


def test_categorical_from_probs_equals_jax():
    b, v = 64, 256
    rcfg, tcfg = _cfgs(temperature=0.9, top_k=40, seed=3)
    x = _logits(5, b, v)
    probs = np.array(jax.jit(lambda l: RS.sample_probs(l, rcfg))(x))
    keys = TS.request_key(3, torch.arange(b), torch.full((b,), 12),
                          TS.ROLE_RESIDUAL)
    ref_keys = jnp.asarray(keys.numpy().astype(np.uint32))
    want = np.asarray(RS.categorical_from_probs(jnp.asarray(probs),
                                                ref_keys))
    got = TS.categorical_from_probs(torch.from_numpy(probs), keys).numpy()
    assert np.mean(got == want) >= 60 / 64
    assert np.all(probs[np.arange(b), got] > 0)       # never a cut token


def test_temperature_zero_is_greedy_bit_for_bit():
    x = torch.from_numpy(_logits(3, 6, 300))
    x[2, 7] = float("nan")
    rids, pos = torch.arange(6), torch.arange(6)
    for cfg in (TS.SamplerConfig(), TS.SamplerConfig(seed=7, top_k=50),
                TS.SamplerConfig(top_p=0.5)):
        got = TS.sample_tokens(x, rids, pos, cfg)
        assert torch.equal(got, TS.greedy_tokens(x))
    want = np.asarray(RS.sample_tokens(jnp.asarray(x.numpy()),
                                       jnp.asarray(rids.numpy()),
                                       jnp.asarray(pos.numpy()),
                                       RS.SamplerConfig()))
    assert np.array_equal(TS.greedy_tokens(x).numpy(), want)


def test_draws_independent_of_batch_composition():
    cfg = TS.SamplerConfig(temperature=0.7, top_k=16, top_p=0.95, seed=5)
    x = torch.from_numpy(_logits(1, 5, 128))
    rids = torch.tensor([3, 9, 4, 7, 11], dtype=torch.int32)
    pos = torch.tensor([2, 17, 5, 9, 1], dtype=torch.int32)
    full = TS.sample_tokens(x, rids, pos, cfg)
    for i in range(5):
        alone = TS.sample_tokens(x[i:i + 1], rids[i:i + 1], pos[i:i + 1],
                                 cfg)
        assert int(alone[0]) == int(full[i])
    perm = torch.tensor([4, 2, 0, 3, 1])
    assert torch.equal(TS.sample_tokens(x[perm], rids[perm], pos[perm], cfg),
                       full[perm])


def test_config_validation_mirrors_the_reference():
    for kw in (dict(temperature=-0.1), dict(top_p=0.0), dict(top_p=1.5),
               dict(top_k=-1)):
        with pytest.raises(ValueError) as ref:
            RS.SamplerConfig(**kw)
        with pytest.raises(ValueError) as got:
            TS.SamplerConfig(**kw)
        assert str(got.value) == str(ref.value)
    assert TS.SamplerConfig().greedy and not TS.SamplerConfig(0.5).greedy
