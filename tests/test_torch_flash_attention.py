"""Prefill flash attention: the port's plain versions vs the JAX Pallas
kernels `flash_attention` and `dpa_flash_attention` (interpret mode under
`jax.jit`), on the same numpy inputs.

  f32 flash   rtol / atol 2e-5 (the reference kernel's own pin against
              its oracle): the plain version takes one global softmax,
              the kernel an online one, so they differ by f32 rounding.
  DPA flash   rtol 1e-4, atol 0.05 (`SPEC_ATOL["fp8_e4m3"]` of
              tests/test_attention_dpa.py): the port loops over the same
              key blocks, but an ulp of a logit can move a probability
              across an E4M3 rounding midpoint.  Measured on these
              inputs: no output off by more than 1e-5 in five of the
              eight cases (max error 6e-7); in three, 0.13 %, 0.19 % and
              0.38 % of the outputs (max error 1.1e-3, a flipped code).
              `_report` asserts a share of at most 1 %.

Cases: causal and sliding window, GQA 8/2 and 4/1, hd 64 and 128,
Sq = Sk and Sq < Sk, a length (200) where `_fit_block` gives bq = bk =
100, raw K/V on the fp8 and fp4 grids and cache rows (fp8, unpacked and
packed fp4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kvcache as RKV  # noqa: E402
from repro.kernels import flash_attention as RFA  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels.registry import _fit_block  # noqa: E402

SPEC_ATOL_FP8 = 0.05


def _qkv(seed, B, H, Hkv, Sq, Sk, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, hd)).astype(np.float32)
    return q, k, v


def _t(a):
    return torch.from_numpy(np.array(a))


def _report(got, want):
    """Share of outputs off by more than 1e-5 (asserted at most 1 %)."""
    off = float(np.mean(np.abs(got - want) > 1e-5))
    assert off <= 0.01, off
    return off


@pytest.mark.parametrize("causal,window,H,Hkv,Sq,Sk", [
    (True, None, 8, 2, 256, 256),
    (True, 64, 8, 2, 256, 256),
    (True, None, 4, 1, 256, 256),
    (False, None, 4, 1, 256, 256),
    (True, None, 4, 2, 128, 256),
])
def test_plain_f32_flash_matches_pallas(causal, window, H, Hkv, Sq, Sk):
    q, k, v = _qkv(H * 10 + (window or 0) + Sq, 2, H, Hkv, Sq, Sk, 64)
    want = RFA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               interpret=True)
    n = TFA.flash_attention.launches
    got = TFA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              window=window)
    assert TFA.flash_attention.launches == n    # CPU: the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("fmt_kv,hd,Sq,Sk,window", [
    ("fp4_e2m1", 64, 256, 256, None),
    ("fp8_e4m3", 128, 256, 256, None),
    ("fp4_e2m1", 64, 128, 256, None),
    ("fp8_e4m3", 64, 200, 200, None),
    ("fp4_e2m1", 64, 256, 256, 64),
])
def test_plain_dpa_flash_raw_matches_pallas(fmt_kv, hd, Sq, Sk, window):
    q, k, v = _qkv(hd + Sq + Sk, 1, 4, 2, Sq, Sk, hd)
    bq, bk = _fit_block(128, Sq), _fit_block(128, Sk)
    want = RFA.dpa_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), fmt="fp8_e4m3",
        fmt_kv=fmt_kv, window=window, bq=bq, bk=bk, interpret=True)
    got = TFA.dpa_flash_attention(_t(q), _t(k), _t(v), fmt="fp8_e4m3",
                                  fmt_kv=fmt_kv, window=window, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=SPEC_ATOL_FP8)
    _report(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fmt_kv,packed,hd,Sq", [
    ("fp4_e2m1", True, 64, 256),
    ("fp4_e2m1", False, 128, 256),
    ("fp8_e4m3", False, 64, 128),
])
def test_plain_dpa_flash_cache_mode_matches_pallas(fmt_kv, packed, hd, Sq):
    """Cache mode: K/V arrive as the reference's quantized cache rows
    (codes + per-row scales, quantized under `jax.jit`, whose scale is
    the port's: F1); both sides widen them in the prologue."""
    Sk = 256
    q, k, v = _qkv(hd + Sq + 1, 1, 4, 2, Sq, Sk, hd)
    quant = jax.jit(RKV.quantize_kv, static_argnames=("fmt", "packed"))
    kc, ks = quant(jnp.asarray(k), fmt=fmt_kv, packed=packed)
    vc, vs = quant(jnp.asarray(v), fmt=fmt_kv, packed=packed)
    want = RFA.dpa_flash_attention(
        jnp.asarray(q), kc, vc, ks, vs, fmt="fp8_e4m3", fmt_kv=fmt_kv,
        kv_quant=True, kv_packed=packed, interpret=True)

    def codes(c):
        c = np.asarray(c)
        if fmt_kv == "fp8_e4m3":
            return _t(c.view(np.uint8)).view(torch.float8_e4m3fn)
        return _t(c)
    got = TFA.dpa_flash_attention(
        _t(q), codes(kc), codes(vc), _t(np.asarray(ks)), _t(np.asarray(vs)),
        fmt="fp8_e4m3", fmt_kv=fmt_kv, kv_quant=True, kv_packed=packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=SPEC_ATOL_FP8)
    _report(got.numpy(), np.asarray(want))
    # the cache rows hold the values raw K/V quantize to: same output
    raw = TFA.dpa_flash_attention(_t(q), _t(k), _t(v), fmt="fp8_e4m3",
                                  fmt_kv=fmt_kv)
    assert torch.equal(raw, got)


def test_plain_dpa_flash_p_codes_and_block_contract():
    """`p_codes` receives the E4M3 code of every quantized probability
    (zeros above the causal diagonal), and bk is part of the numerics:
    one key block of 256 gives another output than two of 128."""
    q, k, v = _qkv(5, 1, 4, 2, 256, 256, 64)
    codes = torch.zeros((1, 4, 256, 256), dtype=torch.uint8)
    two = TFA.dpa_flash_attention(_t(q), _t(k), _t(v), fmt="fp8_e4m3",
                                  fmt_kv="fp4_e2m1", p_codes=codes)
    assert not codes.triu(1).any() and bool(codes.diagonal(0, 2, 3).all())
    one = TFA.dpa_flash_attention(_t(q), _t(k), _t(v), fmt="fp8_e4m3",
                                  fmt_kv="fp4_e2m1", bq=256, bk=256)
    assert not torch.equal(one, two)


def test_fit_block():
    assert [_fit_block(128, s) for s in (4096, 1000, 200, 96, 7)] == \
        [128, 125, 100, 96, 7]


def test_off_the_cpu_the_wrappers_launch_or_raise():
    """A tensor that is not on the CPU never takes the plain version: an
    unserved format raises NotImplementedError naming the ROADMAP item,
    a served one goes to the launch (which refuses a non-CUDA device)."""
    q = torch.empty((1, 4, 128, 64), device="meta")
    k = torch.empty((1, 2, 128, 64), device="meta")
    with pytest.raises(NotImplementedError,
                       match="Queue 2 under dpa_flash_attention"):
        TFA.dpa_flash_attention(q, k, k, fmt="fp4_e2m1")
    for call in (lambda: TFA.dpa_flash_attention(q, k, k, fmt="fp8_e4m3",
                                                 fmt_kv="fp4_e2m1"),
                 lambda: TFA.flash_attention(q, k, k)):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
