"""The port's data pipeline (`repro_torch.data.pipeline`) and the threefry
draws it adds (`split`, `bernoulli`, `categorical` over a shape) against
the reference's, on the CPU.

  split, bernoulli     equal to `jax.random.split` / `bernoulli` bit for
                       bit (integer hashing and one compare of a
                       uniform that is itself bit for bit).
  categorical(shape)   equal to `jax.random.categorical(key, logits,
                       shape=...)` wherever the reference's Gumbel
                       winner leads the runner-up by more than 8 ulp (the
                       sampler's contract, tests/test_torch_sampler.py:
                       the noise passes through `log`, whose last bit
                       differs); the test counts the positions within 8
                       ulp (0 on these inputs) and checks the chunked
                       draw (small `DRAW_CHUNK`) equals the one-piece one.
  SyntheticLM.batch    tokens and labels equal the reference's at several
                       steps, seeds and shards, with the same margin
                       count; batch(step) is a pure function of (seed,
                       step, shard) in the port.
  MemmapTokens.batch   numpy on both sides: bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as RP  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.serving import threefry as TF  # noqa: E402

MARGIN_ULPS = 8


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


def _key(seed, *folds):
    jk, tk = jax.random.PRNGKey(seed), TF.prng_key(seed)
    for f in folds:
        jk, tk = jax.random.fold_in(jk, f), TF.fold_in(tk, f)
    return jk, tk


@pytest.mark.parametrize("seed,folds,num", [(0, (), 2), (3, (7,), 2),
                                            (2**31 - 1, (5, 1), 3),
                                            (11, (0, 0), 5)])
def test_split_matches_jax(seed, folds, num):
    jk, tk = _key(seed, *folds)
    want = np.asarray(jax.random.split(jk, num)).astype(np.int64)
    assert np.array_equal(TF.split(tk, num).numpy(), want)


@pytest.mark.parametrize("shape", [(2, 16), (3, 257), (1, 1)])
def test_bernoulli_matches_jax(shape):
    jk, tk = _key(4, 9)
    want = np.asarray(jax.random.bernoulli(jk, 0.5, shape))
    got = TF.bernoulli(tk, 0.5, shape).numpy()
    assert got.shape == want.shape and np.array_equal(got, want)
    if got.size > 1:
        assert 0 < got.mean() < 1


def _zipf_logits(v):
    p = 1.0 / np.arange(1, v + 1, dtype=np.float64)
    return np.log(p / p.sum()).astype(np.float32)


def _close_draws(jkey, logits, shape):
    """Per draw: does the reference's winner lead by at most 8 ulp?"""
    z = np.asarray(jax.random.gumbel(jkey, (*shape, logits.shape[-1]),
                                     jnp.float32)) + logits
    top2 = np.sort(z, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= MARGIN_ULPS * np.spacing(
        np.abs(top2[..., 1]))


@pytest.mark.parametrize("v,shape", [(256, (4, 33)), (1000, (2, 65)),
                                     (49155, (1, 7))])
def test_categorical_shape_matches_jax(v, shape, monkeypatch):
    jk, tk = _key(1, 2)
    logits = _zipf_logits(v)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits),
                                             shape=shape))
    got = TF.categorical(tk, torch.from_numpy(logits), shape=shape).numpy()
    close = _close_draws(jk, logits, shape)
    print(f"V {v}, {shape}: {int(close.sum())} draws within "
          f"{MARGIN_ULPS} ulp")
    assert np.array_equal(got[~close], want[~close])
    # the chunked draw: a few rows a chunk, rows split across the shape
    monkeypatch.setattr(TF, "DRAW_CHUNK", 3 * v)
    chunked = TF.categorical(tk, torch.from_numpy(logits), shape=shape)
    assert np.array_equal(chunked.numpy(), got)


CASES = [dict(vocab_size=256, batch=4, seq=32, seed=0),
         dict(vocab_size=256, batch=8, seq=16, seed=3, n_shards=2, shard=1),
         dict(vocab_size=1000, batch=2, seq=64, seed=5)]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("step", [0, 7, 1000])
def test_synthetic_batch_matches_jax(case, step):
    kw = CASES[case]
    want = RP.make_pipeline(RP.DataConfig(**kw)).batch(step)
    pipe = TP.make_pipeline(TP.DataConfig(**kw), device="cpu")
    got = pipe.batch(step)
    # the reference's base draw, to count its close Gumbel margins
    key = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(kw["seed"]), step), kw.get("shard", 0))
    k1, _ = jax.random.split(key)
    b = kw["batch"] // kw.get("n_shards", 1)
    close = _close_draws(k1, _zipf_logits(kw["vocab_size"]),
                         (b, kw["seq"] + 1))
    print(f"case {case}, step {step}: {int(close.sum())} draws within "
          f"{MARGIN_ULPS} ulp")
    assert not close.any()
    for name in ("tokens", "labels"):
        assert got[name].dtype == torch.int64
        assert np.array_equal(got[name].numpy(), np.asarray(want[name]))
    assert torch.equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_synthetic_batch_is_pure_in_seed_step_shard():
    cfg = TP.DataConfig(vocab_size=256, batch=8, seq=16, seed=3)
    p1, p2 = TP.make_pipeline(cfg, "cpu"), TP.make_pipeline(cfg, "cpu")
    a = p1.batch(5)["tokens"]
    p1.batch(3)
    assert torch.equal(p1.batch(5)["tokens"], a)
    assert torch.equal(p2.batch(5)["tokens"], a)
    assert not torch.equal(p1.batch(6)["tokens"], a)
    shards = [TP.make_pipeline(TP.DataConfig(vocab_size=256, batch=8, seq=16,
                                             seed=3, n_shards=2, shard=s),
                               "cpu").batch(5)["tokens"] for s in (0, 1)]
    assert shards[0].shape == (4, 16)
    assert not torch.equal(shards[0], shards[1])


@pytest.mark.parametrize("vocab", [512, 70000])
def test_memmap_batch_bit_for_bit(tmp_path, vocab):
    dtype = np.uint32 if vocab > 65535 else np.uint16
    path = tmp_path / "tokens.bin"
    (np.arange(10000, dtype=np.int64) * 7919 % vocab).astype(dtype).tofile(
        str(path))
    kw = dict(vocab_size=vocab, batch=4, seq=32, kind="memmap",
              path=str(path), seed=2, n_shards=2, shard=1)
    for step in (0, 9):
        want = RP.make_pipeline(RP.DataConfig(**kw)).batch(step)
        got = TP.make_pipeline(TP.DataConfig(**kw), device="cpu").batch(step)
        for name in ("tokens", "labels"):
            assert np.array_equal(got[name].numpy(), np.asarray(want[name]))


# jax.random.normal's erf_inv and the port's copy of it (its log1p is
# ATen's): at most 3 ulp apart on these draws
NORMAL_ULPS = 4


def test_stub_frontends_and_default_device():
    """The stub front ends' batches (frames beside the tokens, or
    embeddings in place of them) against the reference's: tokens and
    labels equal, the normals within NORMAL_ULPS ulp; then the CPU
    default refused without a card."""
    for extra in ({"frames": 5}, {}):
        kw = dict(vocab_size=64, batch=2, seq=8, frontend="stub", d_model=16,
                  **extra)
        want = RP.make_pipeline(RP.DataConfig(**kw)).batch(3)
        got = TP.make_pipeline(TP.DataConfig(**kw), "cpu").batch(3)
        assert set(got) == set(want)
        for name, w in want.items():
            g, w = got[name].numpy(), np.asarray(w)
            assert g.shape == w.shape, name
            if w.dtype == np.float32:
                ulp = np.spacing(np.abs(w))
                assert np.all(np.abs(g - w) <= NORMAL_ULPS * ulp), name
            else:
                assert np.array_equal(g, w), name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TP.make_pipeline(TP.DataConfig(vocab_size=64, batch=2, seq=8))
