"""Port numerics core vs the JAX reference, bit for bit.

The reference runs under `jax.jit`, as the engine runs it (fault F1:
jitted XLA turns `amax / target` into `amax * f32(1/target)`, and the
port reproduces that rounding).  Inputs come from numpy seeds and cover
±0, NaN, every E2M1 midpoint tie, values one ulp either side of the
ties, and the target formats' subnormals.

Out of the bit contract: f32-subnormal inputs (|x| < 2^-126).  XLA on the
CPU treats them as zero (flush-to-zero / denormals-are-zero), PyTorch
and the CUDA kernels keep them; the quantizers only meet them where a
row mixes values 38 orders of magnitude apart.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# `repro.core` re-exports a function named `quantize`, which shadows the
# submodule as a package attribute: fetch the modules themselves
RF = importlib.import_module("repro.core.formats")
RP = importlib.import_module("repro.core.packing")
RPOL = importlib.import_module("repro.core.policy")
RQ = importlib.import_module("repro.core.quantize")
from repro_torch.core import formats as TF  # noqa: E402
from repro_torch.core import packing as TP  # noqa: E402
from repro_torch.core import policy as TPOL  # noqa: E402
from repro_torch.core import quantize as TQ  # noqa: E402

MIDS = np.array([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0], np.float32)


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _fp4_inputs():
    rng = np.random.default_rng(0)
    up = np.nextafter(MIDS, np.float32(np.inf))
    down = np.nextafter(MIDS, np.float32(0))
    special = np.array([0.0, -0.0, np.nan, 6.0, -6.0, 2.0 ** -126,
                        -2.0 ** -126, 0.1, -0.1, 0.5, -0.5, 1.0, 1.5, 2.0,
                        3.0, 4.0], np.float32)
    x = np.concatenate([MIDS, -MIDS, up, -up, down, -down, special,
                        rng.uniform(-6, 6, 4000).astype(np.float32)])
    return x


def test_encode_fp4_bit_exact():
    x = _fp4_inputs()
    want = np.asarray(jax.jit(RQ.encode_fp4)(jnp.asarray(x)))
    got = TQ.encode_fp4(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    # the reference's quirks: -0.0 and NaN both encode to code 0
    assert got[np.where(np.isnan(x))[0][0]] == 0
    assert got[np.where((x == 0) & np.signbit(x))[0][0]] == 0


def test_decode_fp4_every_code_bit_exact():
    codes = np.arange(16, dtype=np.uint8)
    want = np.asarray(jax.jit(RQ.decode_fp4)(jnp.asarray(codes)))
    got = TQ.decode_fp4(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))   # -0.0 too


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp16", "bf16", "fp4_e2m1"])
def test_cast_to_bit_exact(fmt):
    rng = np.random.default_rng(1)
    f = RF.get_format(fmt)
    x = np.concatenate([
        rng.standard_normal(3000) * f.max_finite / 4,
        rng.standard_normal(1000) * f.min_subnormal * 8,   # subnormals
        [0.0, -0.0, f.max_finite, -f.max_finite,
         min(2 * f.max_finite, 3e38), f.min_subnormal / 2,
         1.5 * f.min_subnormal]]).astype(np.float32)
    x = x[(np.abs(x) >= 2.0 ** -126) | (x == 0)]          # f32 normals
    want = np.asarray(jax.jit(lambda v: RQ.cast_to(v, fmt).astype(
        jnp.float32))(jnp.asarray(x)))
    got = TQ.cast_to(torch.from_numpy(x), fmt).to(torch.float32).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _scale_inputs(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    x *= np.exp2(rng.integers(-20, 20, size=shape[:-1] + (1,)))
    x[0] = 0.0                                   # eps floor
    # tiny f32 normals: amax * f32(1/target) lands below the 2^-126 floor
    x[1] = (np.sign(x[1]) * rng.uniform(2.0 ** -126, 4e-38, shape[-1])
            ).astype(np.float32)
    return x


@pytest.mark.parametrize("fmt", ["fp8_e4m3", "fp4_e2m1", "fp16", "bf16"])
def test_scales_and_row_grid_bit_exact(fmt):
    rng = np.random.default_rng(2)
    x = _scale_inputs(rng, (64, 128))
    target = RF.get_format(fmt).quant_target
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jax.jit(lambda v: RQ.absmax_block_scale(v, target))(xj),
         TQ.absmax_block_scale(xt, target)),
        (jax.jit(lambda v: RQ.compute_scale(v, fmt, axis=0))(xj),
         TQ.compute_scale(xt, fmt, dim=0)),
        (jax.jit(lambda v: RQ.compute_scale(v, fmt, axis=-1))(xj),
         TQ.compute_scale(xt, fmt, dim=-1)),
        (jax.jit(lambda v: RQ.compute_scale(v, fmt))(xj),
         TQ.compute_scale(xt, fmt)),
    ]
    gj, sj = jax.jit(lambda v: RQ.quant_rows_grid(v, fmt))(xj)
    gt, st = TQ.quant_rows_grid(xt, fmt)
    pairs += [(gj, gt), (sj, st)]
    for want, got in pairs:
        want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_compute_scale_bf16_weights_bit_exact():
    """The load-time weight prep quantizes bf16-cast weights: the eps
    clamp runs in bf16, the reciprocal multiply in f32."""
    rng = np.random.default_rng(3)
    w = rng.standard_normal((96, 40)).astype(np.float32) * 0.05
    wj = jnp.asarray(w).astype(jnp.bfloat16)
    wt = torch.from_numpy(w).to(torch.bfloat16)
    for fmt in ("fp4_e2m1", "fp8_e4m3"):
        want = jax.jit(lambda v: RQ.compute_scale(v, fmt, axis=0))(wj)
        got = TQ.compute_scale(wt, fmt, dim=0)
        np.testing.assert_array_equal(_bits(np.asarray(want)),
                                      _bits(got.numpy()))


def test_reciprocal_multiply_is_the_jitted_rounding():
    """F1: the port's scale equals jitted JAX where eager JAX (a true
    division) differs — the case that makes the rounding choice matter."""
    rng = np.random.default_rng(4)
    a = np.abs(rng.standard_normal(20000)).astype(np.float32) + 1e-3
    jit = np.asarray(jax.jit(lambda v: v / 448.0)(jnp.asarray(a)))
    got = (torch.from_numpy(a) * TQ.recip(448.0)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(jit))
    assert np.any(_bits(a / np.float32(448.0)) != _bits(got))


def test_pack_unpack_bit_exact():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16, size=(6, 10, 8), dtype=np.uint8)
    ct = torch.from_numpy(codes)
    np.testing.assert_array_equal(TP.pack_fp4(ct).numpy(),
                                  np.asarray(RP.pack_fp4(codes)))
    for dim in (0, 1, 2, -1):
        if codes.shape[dim] % 2:
            continue
        want = np.asarray(RP.pack_fp4_axis(codes, dim))
        got = TP.pack_fp4_axis(ct, dim)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(TP.unpack_fp4_axis(got, dim).numpy(),
                                      codes)
    np.testing.assert_array_equal(TP.unpack_fp4(TP.pack_fp4(ct)).numpy(),
                                  codes)
    with pytest.raises(ValueError):
        TP.pack_fp4(torch.zeros((3, 5), dtype=torch.uint8))
    for fmt in ("fp32", "fp16", "fp8_e4m3", "fp4_e2m1"):
        for packed in (True, False):
            assert TP.operand_nbytes(1001, fmt, packed=packed) == \
                RP.operand_nbytes(1001, fmt, packed=packed)


def test_policy_and_format_tables_match_reference():
    assert set(TPOL.POLICIES) == set(RPOL.POLICIES)
    for name, pol in RPOL.POLICIES.items():
        assert dataclasses.asdict(TPOL.POLICIES[name]) == \
            dataclasses.asdict(pol), name
        assert TPOL.POLICIES[name].dpa_terms == pol.dpa_terms
    for name, f in RF.FORMATS.items():
        t = TF.get_format(name)
        for attr in ("bits", "bias", "emin", "emax", "max_finite",
                     "min_subnormal", "quant_target", "precision"):
            assert getattr(t, attr) == getattr(f, attr), (name, attr)
    with pytest.raises(ValueError):
        TPOL.TransPrecisionPolicy(fused_quant=True)
    with pytest.raises(ValueError):
        TPOL.TransPrecisionPolicy(fmt_kv="fp8_e4m3", kv_packed=True)
