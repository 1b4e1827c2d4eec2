"""Floating-point format descriptors (TransDot Table I plus BF16/E5M2).

    FP32  E8M23   IEEE-754 binary32
    FP16  E5M10   IEEE-754 binary16
    BF16  E8M7    bfloat16
    FP8   E4M3    OCP FP8 E4M3 ("fn": no infinities, NaN = S.1111.111)
    FP8   E5M2    OCP FP8 E5M2 (IEEE-like specials)
    FP4   E2M1    OCP FP4 E2M1 (no infinities, no NaN)

Port of `repro.core.formats`: the descriptor table and the bit-level
decode / encode the DPA golden model (`repro_torch.core.dpa`) runs on.
Decode produces the unpacked representation

    value = (-1)^sign * mant * 2^(exp - man_bits)

where ``mant`` carries the implicit bit for normals and the raw fraction
for subnormals (``exp`` pinned at ``1 - bias``).  Codes are int64 torch
tensors on any device (every op is integer arithmetic, so the CPU and the
card give the same bits); numpy arrays enter as CPU tensors, and the
numpy edge (`np_to_codes`, `codes_to_np`, `float_to_codes` on numpy data)
gives the reference's uint32 codes.

The value containers are torch dtypes: f32, f16, bf16, float8_e4m3fn,
float8_e5m2, and uint8 codes (one a byte) for E2M1, which torch lacks.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    name: str
    exp_bits: int
    man_bits: int
    has_inf: bool = True
    # "ieee": exp==all-ones encodes inf (mant==0) / NaN (mant!=0)
    # "fn":   no inf; only exp==all-ones & mant==all-ones is NaN (OCP E4M3)
    # "none": every code is finite (OCP E2M1)
    special: str = "ieee"

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def precision(self) -> int:
        return self.man_bits + 1

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def emax(self) -> int:
        if self.special == "ieee":
            return (1 << self.exp_bits) - 2 - self.bias
        return (1 << self.exp_bits) - 1 - self.bias

    @property
    def max_finite(self) -> float:
        if self.special == "ieee":
            frac = 2.0 - 2.0 ** (-self.man_bits)
        elif self.special == "fn":
            frac = 2.0 - 2.0 ** (-self.man_bits) * 2.0
        else:
            frac = 2.0 - 2.0 ** (-self.man_bits)
        return frac * 2.0 ** self.emax

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.emin - self.man_bits)

    @property
    def quant_target(self) -> float:
        """absmax target for quantization scaling, capped at 2^14 so that
        wide-range formats (bf16/fp16) cannot push fp32-accumulated dot
        products into overflow; narrow formats use their full range (fp8
        448, fp4 6)."""
        return min(self.max_finite, 2.0 ** 14)

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1

    def code_dtype(self) -> np.dtype:
        """The unsigned numpy dtype of a code's width.  Inside the port
        codes are int64 tensors (torch's uint16 / uint32 lack most ops);
        this is their width at the numpy edge."""
        return np.dtype(np.uint32 if self.bits > 16 else
                        np.uint16 if self.bits > 8 else np.uint8)


FP32 = FloatFormat("fp32", 8, 23)
FP16 = FloatFormat("fp16", 5, 10)
BF16 = FloatFormat("bf16", 8, 7)
FP8_E4M3 = FloatFormat("fp8_e4m3", 4, 3, has_inf=False, special="fn")
FP8_E5M2 = FloatFormat("fp8_e5m2", 5, 2)
FP4_E2M1 = FloatFormat("fp4_e2m1", 2, 1, has_inf=False, special="none")

FORMATS = {f.name: f for f in (FP32, FP16, BF16, FP8_E4M3, FP8_E5M2, FP4_E2M1)}
FORMATS.update({"fp8": FP8_E4M3, "fp4": FP4_E2M1})


def get_format(name) -> FloatFormat:
    if isinstance(name, FloatFormat):
        return name
    return FORMATS[name]


# the value container of each format (E2M1: one uint8 code a byte)
_CONTAINER = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "fp4_e2m1": torch.uint8,
}
# integer dtypes of the containers' widths, to view them as
_BITS_DTYPE = {32: torch.int32, 16: torch.int16, 8: torch.uint8,
               4: torch.uint8}
# float64's fields, the source of `float_to_codes` (not a Table-I format)
_F64 = FloatFormat("fp64", 11, 52)


def torch_dtype(fmt) -> torch.dtype:
    """The torch dtype fmt's values are stored in (uint8 codes for E2M1)."""
    return _CONTAINER[get_format(fmt).name]


def _int64(codes) -> torch.Tensor:
    if isinstance(codes, torch.Tensor):
        return codes.to(torch.int64)
    return torch.from_numpy(np.asarray(codes).astype(np.int64))


def _shl1(n):
    """1 << n for an int64 tensor of shift counts in [0, 62]."""
    return torch.ones_like(n) << n


# -----------------------------------------------------------------------------
# Decode: code -> (sign, mant, exp, is_zero, is_inf, is_nan)
# -----------------------------------------------------------------------------

def decode(codes, fmt: FloatFormat):
    """Unpack integer codes (tensor or numpy) into int64 sign / significand
    / exponent tensors and bool special flags: ``sign`` in {0, 1}, ``mant``
    the integer significand with the implicit bit for normals, ``exp`` the
    unbiased exponent, value = (-1)^s * mant * 2^(exp - man_bits)."""
    c = _int64(codes)
    sign = (c >> (fmt.exp_bits + fmt.man_bits)) & 1
    e_raw = (c >> fmt.man_bits) & fmt.exp_mask
    frac = c & fmt.man_mask

    is_sub = e_raw == 0
    mant = torch.where(is_sub, frac, frac | (1 << fmt.man_bits))
    exp = torch.where(is_sub, torch.full_like(e_raw, fmt.emin),
                      e_raw - fmt.bias)

    is_zero = is_sub & (frac == 0)
    mant = torch.where(is_zero, 0, mant)

    if fmt.special == "ieee":
        top = e_raw == fmt.exp_mask
        is_inf = top & (frac == 0)
        is_nan = top & (frac != 0)
        mant = torch.where(top, 0, mant)
    elif fmt.special == "fn":
        is_nan = (e_raw == fmt.exp_mask) & (frac == fmt.man_mask)
        is_inf = torch.zeros_like(is_nan)
        mant = torch.where(is_nan, 0, mant)
    else:  # none
        is_inf = torch.zeros_like(is_zero)
        is_nan = torch.zeros_like(is_zero)
    return sign, mant, exp, is_zero, is_inf, is_nan


# -----------------------------------------------------------------------------
# Encode: (sign, mant, exp) -> code, with RNE rounding + subnormal/overflow
# -----------------------------------------------------------------------------

def _encode(sign, mant, exp, sticky, fmt: FloatFormat):
    """`encode_from_parts`, and where the rounded value passed emax."""
    m = fmt.man_bits
    sign, mant, exp = _int64(sign), _int64(mant), _int64(exp)
    sticky = torch.as_tensor(sticky, device=mant.device).to(torch.bool)
    # Current layout: [ 1 . m man bits | G | R ], value = mant * 2^(exp - m - 2)
    # Subnormal: shift right until exp == emin.
    shift = torch.clamp_min(fmt.emin - exp, 0)
    shift_c = torch.clamp_max(shift, m + 4)
    lost = mant & (_shl1(shift_c) - 1)
    sticky = sticky | (lost != 0)
    mant = mant >> shift_c
    exp = exp + shift

    # RNE on [man | G | R+sticky]
    guard = (mant >> 1) & 1
    rnd = mant & 1
    keep = mant >> 2
    round_up = guard & (rnd | sticky.to(torch.int64) | (keep & 1))
    keep = keep + round_up
    # rounding overflow: mantissa carried out
    carried = (keep >> (m + 1)) != 0
    keep = torch.where(carried, keep >> 1, keep)
    exp = torch.where(carried, exp + 1, exp)

    is_zero = keep == 0
    # subnormal results have no implicit bit at position m -> e_raw 0
    is_sub = keep < (1 << m)
    e_raw = torch.where(is_sub | is_zero, 0, exp + fmt.bias)
    frac = keep & fmt.man_mask

    overflow = exp > fmt.emax
    top = sign << (fmt.exp_bits + m)
    code = top | (e_raw << m) | frac
    if fmt.has_inf:
        code = torch.where(overflow, top | (fmt.exp_mask << m), code)
    else:
        # saturating encode for inf-less formats
        sat = fmt.man_mask - 1 if fmt.special == "fn" else fmt.man_mask
        code = torch.where(overflow, top | (fmt.exp_mask << m) | sat, code)
    code = torch.where(is_zero, top, code)
    return code, overflow


def encode_from_parts(sign, mant, exp, sticky, fmt: FloatFormat):
    """Round-to-nearest-even encode of value = (-1)^s * mant * 2^(exp -
    man_bits) -> int64 codes.

    ``mant`` must already be normalized so that the implicit bit sits at
    position ``man_bits + 2``: mant has man_bits + 3 significant bits
    (mantissa | guard | round) for a normal result, with any lower bits
    ORed into the boolean ``sticky``.  Handles subnormal underflow,
    overflow (-> inf, or max-finite for formats without inf) and zero."""
    return _encode(sign, mant, exp, sticky, fmt)[0]


def nan_code(fmt: FloatFormat) -> int:
    m = fmt.man_bits
    if fmt.special == "ieee":
        return ((fmt.exp_mask << m) | (1 << (m - 1) if m else 0)
                | (1 if m == 0 else 0))
    if fmt.special == "fn":
        return (fmt.exp_mask << m) | fmt.man_mask
    raise ValueError(f"{fmt.name} has no NaN encoding")


def inf_code(fmt: FloatFormat, sign):
    if not fmt.has_inf:
        raise ValueError(f"{fmt.name} has no inf encoding")
    return (sign << (fmt.exp_bits + fmt.man_bits)) | (fmt.exp_mask
                                                      << fmt.man_bits)


# -----------------------------------------------------------------------------
# containers and numpy <-> code helpers
# -----------------------------------------------------------------------------

def tensor_to_codes(x, fmt) -> torch.Tensor:
    """A tensor in fmt's container -> its int64 codes (bit-cast)."""
    fmt = get_format(fmt)
    if x.dtype != torch_dtype(fmt):
        raise TypeError(f"{fmt.name} codes come from {torch_dtype(fmt)}, got "
                        f"{x.dtype}")
    c = x.view(_BITS_DTYPE[fmt.bits]).to(torch.int64)
    return c & ((1 << fmt.bits) - 1)


def codes_to_tensor(codes, fmt) -> torch.Tensor:
    """int64 codes -> the tensor in fmt's container holding them (bit-cast,
    on the codes' device)."""
    fmt = get_format(fmt)
    c = _int64(codes)
    if fmt.bits > 8:        # two's complement of the container's width
        c = c - ((c >> (fmt.bits - 1)) << fmt.bits)
    return c.to(_BITS_DTYPE[fmt.bits]).view(torch_dtype(fmt))


def np_to_codes(x, fmt: FloatFormat) -> np.ndarray:
    """fmt values -> uint32 codes: a bit-cast of data already in fmt's
    container (a torch tensor, or numpy f16 / f32), else a rounding cast
    as the reference's `np.asarray(x, ml_dtype)` (`float_to_codes`)."""
    fmt = get_format(fmt)
    if isinstance(x, torch.Tensor) and x.dtype == torch_dtype(fmt):
        return tensor_to_codes(x, fmt).cpu().numpy().astype(np.uint32)
    a = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    if (fmt.name, a.dtype) in (("fp32", np.float32), ("fp16", np.float16)):
        return a.view(fmt.code_dtype()).astype(np.uint32)
    return float_to_codes(a.astype(np.float64), fmt)


def codes_to_np(codes, fmt: FloatFormat) -> np.ndarray:
    """Codes -> numpy values: a bit-cast view for fp32 (float32) and fp16
    (float16), exact float64 values for the formats numpy lacks (bf16,
    E4M3, E5M2, E2M1; NaN payloads are not kept)."""
    fmt = get_format(fmt)
    if fmt.name in ("fp32", "fp16"):
        c = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor)
                       else codes)
        return c.astype(fmt.code_dtype()).view(
            np.float32 if fmt.bits == 32 else np.float16)
    sign, mant, exp, _, is_inf, is_nan = decode(codes, fmt)
    v = torch.ldexp(mant.to(torch.float64),
                    (exp - fmt.man_bits).to(torch.float64))
    v = torch.where(is_inf, torch.inf, v)
    v = torch.where(is_nan, torch.nan, v)
    return torch.where(sign == 1, -v, v).cpu().numpy()


# formats the reference casts to from float64 through float32 (ml_dtypes
# converts via float: two roundings); fp16 (numpy) and fp32 round once
_VIA_F32 = ("bf16", "fp8_e4m3", "fp8_e5m2", "fp4_e2m1")


def _nan_codes(sign, frac, src: FloatFormat, fmt: FloatFormat):
    """The codes the reference's casts give a NaN of src (sign, fraction):
    numpy keeps the payload's top bits (f32 sets the quiet bit, f16 keeps
    it nonzero); ml_dtypes gives its canonical NaN with the sign, and for
    E2M1, which has none, code 8 for +NaN and 0 for -NaN."""
    m = fmt.man_bits
    top = sign << (fmt.bits - 1)
    if fmt.name == "fp32":
        return top | (fmt.exp_mask << m) | (1 << (m - 1)) \
            | (frac >> (src.man_bits - m))
    if fmt.name == "fp16":
        p = frac >> (src.man_bits - m)
        return top | (fmt.exp_mask << m) | torch.where(p == 0, 1, p)
    if fmt.name == "fp4_e2m1":
        return (1 - sign) << 3
    return top | nan_code(fmt)


def _round_codes(codes, src: FloatFormat, fmt: FloatFormat):
    """src codes -> fmt codes, one RNE rounding, with the reference's
    specials: inf -> inf (E4M3: NaN, E2M1: the largest value) and
    overflow the same; NaN by `_nan_codes`."""
    sign, mant, exp, _, is_inf, is_nan = decode(codes, src)
    d = src.man_bits - fmt.man_bits - 2
    sticky = (mant & ((1 << d) - 1)) != 0
    code, over = _encode(sign, mant >> d, exp, sticky, fmt)
    top = sign << (fmt.bits - 1)
    m = fmt.man_bits
    if fmt.has_inf:
        inf = top | (fmt.exp_mask << m)
    elif fmt.special == "fn":
        inf = top | nan_code(fmt)
        code = torch.where(over, inf, code)
    else:
        inf = top | (fmt.exp_mask << m) | fmt.man_mask
    code = torch.where(is_inf, inf, code)
    return torch.where(is_nan, _nan_codes(sign, codes & src.man_mask, src,
                                          fmt), code)


def float_to_codes(x, fmt: FloatFormat):
    """Cast float data into fmt codes as the reference's
    `np.asarray(x).astype(ml_dtype)` does, from each value's float64 bit
    fields by the port's own RNE encode, so every device gives the same
    codes: fp32 and fp16 round once; bf16, E4M3, E5M2 and E2M1 round to
    f32 first, then to the format (ml_dtypes' two roundings).  E4M3
    overflow and inf give NaN, E2M1's saturate.

    A tensor gives int64 codes on its device; numpy data gives a uint32
    array (the reference's)."""
    fmt = get_format(fmt)
    is_np = not isinstance(x, torch.Tensor)
    t = torch.from_numpy(np.asarray(x, np.float64)) if is_np \
        else x.to(torch.float64)
    codes = t.contiguous().view(torch.int64)
    if fmt.name in _VIA_F32:
        codes = _round_codes(codes, _F64, FP32)
        codes = _round_codes(codes, FP32, fmt)
    else:
        codes = _round_codes(codes, _F64, fmt)
    return codes.numpy().astype(np.uint32) if is_np else codes
