"""The TransDot datapath in the port, against the JAX reference, on the CPU.

- `core.formats`: `decode`, `encode_from_parts` and `float_to_codes`
  against the reference's over every code of each format up to 16 bits
  and seeded samples of f32 codes; `float_to_codes` also on ties, on
  values next to a tie after f32 rounding (the reference rounds bf16, fp8
  and fp4 through f32), on subnormals, overflow, NaN (with payloads) and
  inf; the containers' bit-casts both ways.
- `core.dpa.dpa_codes` against `jax.jit` of the reference's
  `dpa_codes_jit`, bit for bit: the six golden modes at a narrow window
  (the golden file, `test_torch_dpa_golden.py`, holds them at the
  default one), E5M2 and bf16 operands at both, a few hundred lanes each
  with special codes; the float front end `dpa`.
- `core.oracle` and `core.fpnew_ref` against the reference's.
- the prequant kernels' plain versions against the reference's
  `dpa_matmul_ref` for each of `tests/test_kernels.py`'s formats and for
  E2M1 weights x E4M3 activations, at its pin (rtol 2e-5 / atol 2e-4: f32
  sums in another order); the wrapper's refusals before it loads the
  kernel library; and a numpy model of the kernel's exact widening of
  E4M3, E5M2 and E2M1 codes to fp16 (byte permutes) over every code.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dpa as RD  # noqa: E402  (enables JAX's x64)
from repro.core import formats as RF  # noqa: E402
from repro.core import fpnew_ref as RFP  # noqa: E402
from repro.core import oracle as RO  # noqa: E402
from repro.kernels import ref as RREF  # noqa: E402
from repro.kernels.ops import _quant_operand  # noqa: E402
from repro_torch.core import dpa as PD  # noqa: E402
from repro_torch.core import formats as PF  # noqa: E402
from repro_torch.core import fpnew_ref as PFP  # noqa: E402
from repro_torch.core import oracle as PO  # noqa: E402
from repro_torch.core.packing import pack_fp4_axis  # noqa: E402
from repro_torch.kernels import dpa_grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import dpa_matmul as DM  # noqa: E402

FORMATS = ["fp32", "fp16", "bf16", "fp8_e4m3", "fp8_e5m2", "fp4_e2m1"]
GOLDEN_MODES = [("fp16", "fp32", 2), ("fp8_e4m3", "fp32", 4),
                ("fp4_e2m1", "fp32", 8), ("fp32", "fp32", 1),
                ("fp16", "fp16", 2), ("fp8_e4m3", "fp16", 4)]
EXTRA_MODES = [("fp8_e5m2", "fp32", 4), ("bf16", "fp32", 2)]
NARROW = 24                      # window_bits of the narrow-window cases
LANES = 320


def _codes(fmt, rng, n=40000):
    """Every code of a format up to 16 bits, else n seeded ones."""
    f = RF.get_format(fmt)
    if f.bits <= 16:
        return np.arange(1 << f.bits, dtype=np.uint32)
    return rng.integers(0, 1 << f.bits, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_matches_reference(fmt):
    codes = _codes(fmt, np.random.default_rng(1))
    want = RF.decode(codes, RF.get_format(fmt))
    got = PF.decode(codes, PF.get_format(fmt))
    for name, w, g in zip(("sign", "mant", "exp", "zero", "inf", "nan"),
                          want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the values the containers hold
    with np.errstate(invalid="ignore"):
        vals = RF.codes_to_np(codes, RF.get_format(fmt)).astype(np.float64)
    np.testing.assert_array_equal(
        PF.codes_to_np(codes, PF.get_format(fmt)).astype(np.float64), vals)
    t = PF.codes_to_tensor(torch.from_numpy(codes.astype(np.int64)), fmt)
    assert t.dtype == PF.torch_dtype(fmt)
    np.testing.assert_array_equal(PF.tensor_to_codes(t, fmt).numpy(), codes)
    np.testing.assert_array_equal(PF.np_to_codes(t, PF.get_format(fmt)),
                                  codes)
    assert PF.get_format(fmt).code_dtype() == np.dtype(
        RF.get_format(fmt).code_dtype())


@pytest.mark.parametrize("fmt", FORMATS)
def test_encode_from_parts_matches_reference(fmt):
    """Random normalized parts across the whole exponent range, past it
    at both ends (subnormals, underflow to zero, overflow), any sticky."""
    f = PF.get_format(fmt)
    rng = np.random.default_rng(2)
    n = 30000
    sign = rng.integers(0, 2, n)
    mant = rng.integers(1 << (f.man_bits + 2), 1 << (f.man_bits + 3), n)
    exp = rng.integers(f.emin - f.man_bits - 6, f.emax + 3, n)
    sticky = rng.integers(0, 2, n).astype(bool)
    want = np.asarray(RF.encode_from_parts(sign, mant, exp, sticky,
                                           RF.get_format(fmt)))
    got = PF.encode_from_parts(*(torch.from_numpy(a) for a in
                                 (sign, mant, exp, sticky)), f)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    if fmt != "fp4_e2m1":
        assert PF.nan_code(f) == RF.nan_code(RF.get_format(fmt))
    if f.has_inf:
        assert PF.inf_code(f, 1) == RF.inf_code(RF.get_format(fmt), 1)


def _cast_cases(fmt, rng):
    """Float64 data for `float_to_codes`: wide random magnitudes, every
    value of the format, the midpoints between neighbours (ties) and
    values next to them, by less than an f32 half ulp (a tie after f32
    rounding) and by more; subnormals, overflow, NaN with payloads, inf."""
    f = RF.get_format(fmt)
    with np.errstate(invalid="ignore"):
        vals = RF.codes_to_np(_codes(fmt, rng, 4000), f).astype(np.float64)
    vals = np.unique(np.abs(vals[np.isfinite(vals)]))
    if len(vals) > 6000:
        vals = vals[np.sort(rng.choice(len(vals), 6000, replace=False))]
    mids = (vals[1:] + vals[:-1]) / 2
    near = [mids * (1 + s * 2.0 ** -e) for e in (24, 30, 40, 60)
            for s in (1, -1)]
    top = f.max_finite
    nans = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                     0x7FF8123456789ABC, 0x7FF0000000000001,
                     0xFFFC000000000000], np.uint64).view(np.float64)
    special = np.array([np.inf, -np.inf, 0.0, -0.0, 5e-324, -5e-324,
                        2.0 ** -1022, 1e-300, 1e300, -1e300, top,
                        top * 1.01, top * (1 + 2.0 ** -(f.man_bits + 1)),
                        -top * (1 + 2.0 ** -(f.man_bits + 2)), 65520.0,
                        65519.99, 61440.0, 480.0, 464.0, 465.0, 6.5, 7.0,
                        f.min_subnormal / 2, f.min_subnormal * 0.75,
                        f.min_subnormal * 0.5000001])
    wide = rng.normal(size=20000) * 10.0 ** rng.integers(-45, 40, 20000)
    return np.concatenate([wide, vals, -vals, mids, -mids, *near,
                           special, nans])


@pytest.mark.parametrize("fmt", FORMATS)
def test_float_to_codes_matches_reference(fmt):
    x = _cast_cases(fmt, np.random.default_rng(3))
    with np.errstate(all="ignore"):
        want = RF.float_to_codes(x, RF.get_format(fmt))
    got = PF.float_to_codes(x, PF.get_format(fmt))
    assert got.dtype == np.uint32
    bad = got != want
    assert not bad.any(), (x[bad][:4], got[bad][:4], want[bad][:4])
    # a tensor gives the same codes as int64, on its device
    t = PF.float_to_codes(torch.from_numpy(x), fmt)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(t.numpy(), want.astype(np.int64))
    # np_to_codes: a rounding cast of float data, a bit-cast of f16 / f32
    np.testing.assert_array_equal(PF.np_to_codes(x, PF.get_format(fmt)),
                                  want)
    if fmt in ("fp16", "fp32"):
        with np.errstate(all="ignore"):
            narrow = x.astype(RF.get_format(fmt).ml_dtype)
        np.testing.assert_array_equal(PF.np_to_codes(narrow, fmt),
                                      RF.np_to_codes(narrow,
                                                     RF.get_format(fmt)))


def _mode_codes(rng, fa, fc, n, lanes=LANES):
    """Random codes over the whole code space (specials included) in half
    the lanes, finite codes near one scale in the other half, so sums
    that cancel, round and tie are common."""
    fa, fc = RF.get_format(fa), RF.get_format(fc)
    a = rng.integers(0, 1 << fa.bits, (lanes, n), dtype=np.uint64)
    b = rng.integers(0, 1 << fa.bits, (lanes, n), dtype=np.uint64)
    c = rng.integers(0, 1 << fc.bits, lanes, dtype=np.uint64)
    h = lanes // 2
    a[h:] = RF.float_to_codes(rng.normal(size=(lanes - h, n)), fa)
    b[h:] = RF.float_to_codes(rng.normal(size=(lanes - h, n)), fa)
    c[h:] = RF.float_to_codes(rng.normal(size=lanes - h) * 4, fc)
    return a.astype(np.uint32), b.astype(np.uint32), c.astype(np.uint32)


DPA_CASES = ([(m, NARROW) for m in GOLDEN_MODES]
             + [(m, w) for m in EXTRA_MODES for w in (None, NARROW)])


@pytest.mark.parametrize(
    "mode,window", DPA_CASES,
    ids=[f"{a}x{n}to{c}-W{w or 'default'}" for (a, c, n), w in DPA_CASES])
def test_dpa_codes_matches_reference_jit(mode, window):
    fa, fc, n = mode
    a, b, c = _mode_codes(np.random.default_rng(hash(mode) % 2 ** 32), fa,
                          fc, n)
    want = np.asarray(RD.dpa_codes_jit(a, b, c, fmt_ab=fa, fmt_acc=fc,
                                       window_bits=window))
    got = PD.dpa_codes(torch.from_numpy(a.astype(np.int64)),
                       torch.from_numpy(b.astype(np.int64)),
                       torch.from_numpy(c.astype(np.int64)), fa, fc,
                       window_bits=window)
    assert got.dtype == torch.int64
    bad = got.numpy() != want.astype(np.int64)
    assert not bad.any(), (f"{bad.sum()} lanes differ; first a={a[bad][0]} "
                           f"b={b[bad][0]} c={c[bad][0]}")


def test_dpa_float_front_end_matches_reference():
    rng = np.random.default_rng(4)
    a, b = rng.normal(size=(64, 4)), rng.normal(size=(64, 4))
    c = rng.normal(size=64)
    want = RD.dpa(a, b, c, "fp8_e4m3", "fp16")
    np.testing.assert_array_equal(PD.dpa(a, b, c, "fp8_e4m3", "fp16"), want)
    np.testing.assert_array_equal(
        PFP.sequential_fma(a[:, :2], b[:, :2], c, "fp16", "fp32"),
        RFP.sequential_fma(a[:, :2], b[:, :2], c, "fp16", "fp32"))


@pytest.mark.parametrize("mode", GOLDEN_MODES + EXTRA_MODES,
                         ids=[f"{a}x{n}to{c}"
                              for a, c, n in GOLDEN_MODES + EXTRA_MODES])
def test_oracle_matches_reference(mode):
    fa, fc, n = mode
    a, b, c = _mode_codes(np.random.default_rng(5), fa, fc, n, lanes=256)
    want = RO.dpa_exact(a, b, c, fa, fc)
    got = PO.dpa_exact(a, b, c, fa, fc)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


# the numerics table's modes (benchmarks/paper_tables.py)
SEQ_MODES = [("fp16", "fp16", 2), ("fp8_e4m3", "fp16", 4),
             ("fp8_e4m3", "fp32", 4), ("fp4_e2m1", "fp32", 8)]


@pytest.mark.parametrize("mode", SEQ_MODES,
                         ids=[f"{a}x{n}to{c}" for a, c, n in SEQ_MODES])
def test_sequential_fma_matches_reference(mode):
    fa, fc, n = mode
    a, b, c = _mode_codes(np.random.default_rng(6), fa, fc, n, lanes=64)
    want = np.asarray(RFP.sequential_fma_codes(a, b, c, fa, fc))
    got = PFP.sequential_fma_codes(a, b, c, fa, fc)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        PFP.fma_codes(a[:, 0], b[:, 0], c, fa, fc).numpy(),
        np.asarray(RFP.fma_codes(a[:, 0], b[:, 0], c, fa, fc)))


# -----------------------------------------------------------------------------
# the prequant kernels' plain versions, every format
# -----------------------------------------------------------------------------

def _torch_operand(q, fmt):
    """A reference operand (jnp, the native narrow dtype or uint8 E2M1
    codes) -> the same bits in the port's container."""
    a = np.asarray(q)
    if fmt == "fp4_e2m1":
        return torch.from_numpy(a.astype(np.uint8))
    codes = RF.np_to_codes(a, RF.get_format(fmt))
    return PF.codes_to_tensor(torch.from_numpy(codes.astype(np.int64)), fmt)


PREQUANT_PAIRS = [(f, f) for f in ("fp8_e4m3", "fp4_e2m1", "fp16", "bf16")] \
    + [("fp8_e4m3", "fp4_e2m1")]


@pytest.mark.parametrize("fmt_x,fmt_w", PREQUANT_PAIRS,
                         ids=[f"{x}x{w}" for x, w in PREQUANT_PAIRS])
def test_prequant_plain_versions_match_reference(fmt_x, fmt_w):
    M, K, N, E = 24, 256, 48, 3
    k1, k2 = jax.random.split(jax.random.PRNGKey(K + N))
    x = jax.random.normal(k1, (M, K), jnp.float32)
    w = jax.random.normal(k2, (K, N), jnp.float32)
    xq, sx = _quant_operand(x, fmt_x, -1)
    wq, sw = _quant_operand(w, fmt_w, 0)
    want = np.asarray(jax.jit(RREF.dpa_matmul_ref, static_argnames=(
        "fmt_x", "fmt_w"))(xq, wq, sx, sw, fmt_x=fmt_x, fmt_w=fmt_w))
    tx, tw = _torch_operand(xq, fmt_x), _torch_operand(wq, fmt_w)
    tsx, tsw = (torch.tensor(np.asarray(s, np.float32)) for s in (sx, sw))
    packs = [(False, False)]
    if fmt_w == "fp4_e2m1":
        packs.append((fmt_x == "fp4_e2m1", True))
    for pack_x, pack_w in packs:
        ax = pack_fp4_axis(tx, 1) if pack_x else tx
        aw = pack_fp4_axis(tw, 0) if pack_w else tw
        kw = dict(fmt_x=fmt_x, fmt_w=fmt_w, pack_x=pack_x, pack_w=pack_w)
        got = DM.dpa_matmul_prequant(ax, aw, tsx, tsw, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-4)
        grouped = GM.dpa_grouped_matmul_prequant(
            ax.expand(E, *ax.shape).contiguous(),
            aw.expand(E, *aw.shape).contiguous(),
            tsx.expand(E, M, 1).contiguous(),
            tsw.expand(E, 1, N).contiguous(), **kw)
        for e in range(E):
            np.testing.assert_allclose(grouped[e].numpy(), want, rtol=2e-5,
                                       atol=2e-4)


@pytest.mark.parametrize("case", ["fp16 x bf16", "bf16 x fp16", "packed fp8",
                                  "wrong container"])
def test_prequant_wrapper_refuses_before_loading_the_kernel(case):
    """What the kernel does not serve raises before the library loads (no
    nvcc here: a load would raise RuntimeError instead)."""
    M, K, N = 8, 128, 16
    fx, fw, px, pw = {"fp16 x bf16": ("fp16", "bf16", False, False),
                      "bf16 x fp16": ("bf16", "fp16", False, False),
                      "packed fp8": ("fp8_e4m3", "fp8_e4m3", True, False),
                      "wrong container": ("fp8_e5m2", "fp16", False,
                                          False)}[case]
    xq = torch.zeros(M, K // 2 if px else K, dtype=PF.torch_dtype(fx))
    wq = torch.zeros(K, N, dtype=PF.torch_dtype(fw))
    if case == "wrong container":
        xq = xq.view(torch.uint8)
    want = {"fp16 x bf16": NotImplementedError,
            "bf16 x fp16": NotImplementedError, "packed fp8": ValueError,
            "wrong container": TypeError}[case]
    with pytest.raises(want):
        DM.launch_prequant(xq, wq, torch.ones(M, 1), torch.ones(1, N),
                           torch.empty(M, N), 1, M, K, N, fmt_x=fx,
                           fmt_w=fw, pack_x=px, pack_w=pw, what="test")


# -----------------------------------------------------------------------------
# a numpy model of csrc/dpa_prequant.cu's widening (byte permutes)
# -----------------------------------------------------------------------------

def _byte_perm(a, b, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the eight bytes of (b << 32 | a) (selector bit 3 never set here)."""
    src = (int(b) << 32) | int(a)
    out = 0
    for i in range(4):
        idx = (sel >> (4 * i)) & 0xF
        assert idx < 8
        out |= ((src >> (8 * idx)) & 0xFF) << (8 * i)
    return out


def _fp4x2_to_f16x2(b):
    lut0, lut1 = 0x3E3C3800, 0x46444240
    hi = _byte_perm(lut0, lut1, (b & 7) | ((b >> 4) & 7) << 4) \
        | ((b & 8) << 4) | ((b & 0x80) << 8)
    return _byte_perm(hi, 0, 0x1404)


def _to_f16x2(v, fmt):
    """dpa_prequant.cu to_f16x2 for E5M2 and E2M1 (E4M3 is the card's own
    cvt.rn.f16x2.e4m3x2)."""
    if fmt == "fp8_e5m2":
        return _byte_perm(v, 0, 0x1404)
    if fmt == "fp4_e2m1":
        v = (v & 0xF) | ((v >> 4) & 0xF0)
    return _fp4x2_to_f16x2(v)


def _f16_values(codes, fmt):
    return PF.codes_to_np(codes, PF.get_format(fmt)).astype(np.float16)


def _pair(word):
    """An f16x2 word -> its (low, high) fp16 values."""
    return np.array([word & 0xFFFF, word >> 16], np.uint16).view(np.float16)


@pytest.mark.parametrize("fmt", ["fp8_e5m2", "fp4_e2m1", "packed"])
def test_kernel_widening_gives_the_fp16_values(fmt):
    """Every pair of codes (bytes, or the two nibbles of a packed byte),
    with junk in the bits the kernel must ignore: the f16x2 holds the
    first k's fp16 bits in its low half, exactly."""
    if fmt == "packed":
        f16 = _f16_values(np.arange(16), "fp4_e2m1")
        for byte in range(256):
            got = _pair(_to_f16x2(byte | 0x5A00, "packed"))
            want = f16[[byte & 15, byte >> 4]]
            assert got.view(np.uint16).tolist() == \
                want.view(np.uint16).tolist(), byte
        return
    n = 256 if fmt == "fp8_e5m2" else 16
    f16 = _f16_values(np.arange(n), fmt)
    junk = 0xA0 if fmt == "fp4_e2m1" else 0     # E2M1: a byte's high nibble
    for c0 in range(n):
        for c1 in range(n):
            v = (c0 | junk) | ((c1 | junk) << 8) | (0x3C << 16)
            got = _pair(_to_f16x2(v, fmt))
            # a NaN code gives an fp16 NaN (E5M2: its own payload)
            np.testing.assert_array_equal(got, f16[[c0, c1]],
                                          err_msg=str((c0, c1)))


def test_kernel_packs_unpacked_codes_low_nibble_first():
    """pack_codes4 and the permute after it (the int8 route's widening of
    x): 8 codes a byte -> 4 packed bytes, even k in the low nibble."""
    rng = np.random.default_rng(8)
    for _ in range(200):
        codes = rng.integers(0, 16, 8)
        junk = rng.integers(0, 16, 8) << 4
        raw = (codes | junk).astype(np.uint8)
        words = raw.view(np.uint32)

        def pack4(v):
            lo = int(v) & 0x0F0F0F0F
            return _byte_perm(lo | (lo >> 4), 0, 0x4420)
        got = _byte_perm(pack4(words[0]), pack4(words[1]), 0x5410)
        want = pack_fp4_axis(torch.from_numpy(codes.astype(np.uint8)), 0)
        assert got == int(want.numpy().view(np.uint32)[0])
