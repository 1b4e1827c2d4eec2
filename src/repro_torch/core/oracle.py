"""Exact (big-integer) oracle for trans-precision DPA (a copy of
`repro.core.oracle` over the port's formats).

Computes  round_RNE( sum_i a_i*b_i + c )  with *no* intermediate rounding,
using Python integers (values are scaled to a common power-of-two grid, so
the exact sum is an integer).  This is the reference the golden model
(`repro_torch.core.dpa`) is property-tested against: the windowed hardware
datapath must match the exact result bit-for-bit unless cancellation digs
below its accumulation window (tests check the error bound in that regime).

Pure Python / numpy-object code — test plumbing, not a performance path.
"""
from __future__ import annotations

import numpy as np

from .formats import FloatFormat, get_format, inf_code, nan_code


def _decode_int(code: int, fmt: FloatFormat):
    """code -> (sign, mant, exp) with value = (-1)^s * mant * 2^(exp-man_bits),
    or the strings 'nan'/'inf' for specials."""
    sign = (code >> (fmt.exp_bits + fmt.man_bits)) & 1
    e_raw = (code >> fmt.man_bits) & fmt.exp_mask
    frac = code & fmt.man_mask
    if fmt.special == "ieee" and e_raw == fmt.exp_mask:
        return (sign, None, "nan" if frac else "inf")
    if fmt.special == "fn" and e_raw == fmt.exp_mask and frac == fmt.man_mask:
        return (sign, None, "nan")
    if e_raw == 0:
        return (sign, frac, fmt.emin)
    return (sign, frac | (1 << fmt.man_bits), e_raw - fmt.bias)


def _round_to_format(num: int, scale_exp: int, fmt: FloatFormat):
    """Exact value = num * 2^scale_exp  ->  RNE code in fmt."""
    if num == 0:
        return 0
    sign = 1 if num < 0 else 0
    num = abs(num)
    m = fmt.man_bits
    e = (num.bit_length() - 1) + scale_exp    # exponent of the leading bit
    # quantize to q * 2^ulp_exp with integer q via RNE
    ulp_exp = max(e, fmt.emin) - m
    shift = ulp_exp - scale_exp
    if shift <= 0:
        q = num << (-shift)
    else:
        q = num >> shift
        rem = num & ((1 << shift) - 1)
        half = 1 << (shift - 1)
        if rem > half or (rem == half and (q & 1)):
            q += 1
    if q == 0:
        return sign << (fmt.bits - 1)
    if q.bit_length() > m + 1:                # rounding carry: q == 2^(m+1)
        q >>= 1
        ulp_exp += 1
    if q.bit_length() == m + 1:               # normal
        e_lead = ulp_exp + m
        if e_lead > fmt.emax:
            if fmt.has_inf:
                return (sign << (fmt.bits - 1)) | (fmt.exp_mask << m)
            sat = fmt.man_mask - 1 if fmt.special == "fn" else fmt.man_mask
            return (sign << (fmt.bits - 1)) | (fmt.exp_mask << m) | sat
        return ((sign << (fmt.bits - 1)) | ((e_lead + fmt.bias) << m)
                | (q - (1 << m)))
    # subnormal (ulp_exp == emin - m by construction)
    return (sign << (fmt.bits - 1)) | q


def dpa_exact_code(a_codes, b_codes, c_code, fmt_ab, fmt_acc) -> int:
    """Exact DPA for ONE lane: lists of int codes -> int code in fmt_acc."""
    fmt_ab = get_format(fmt_ab)
    fmt_acc = get_format(fmt_acc)
    terms = []          # (sign, mant:int, exp:int) exact products
    pos_inf = neg_inf = has_nan = False
    for ac, bc in zip(a_codes, b_codes):
        sa, ma, ea = _decode_int(int(ac), fmt_ab)
        sb, mb, eb = _decode_int(int(bc), fmt_ab)
        s = sa ^ sb
        if ea == "nan" or eb == "nan":
            has_nan = True
            continue
        if ea == "inf" or eb == "inf":
            other_zero = (mb == 0 if ea == "inf" and eb not in ("inf",) else
                          (ma == 0 if eb == "inf" and ea not in ("inf",) else False))
            if other_zero:
                has_nan = True
            elif s:
                neg_inf = True
            else:
                pos_inf = True
            continue
        terms.append((s, ma * mb, ea + eb - 2 * fmt_ab.man_bits))
    sc, mc, ec = _decode_int(int(c_code), fmt_acc)
    if ec == "nan":
        has_nan = True
    elif ec == "inf":
        if sc:
            neg_inf = True
        else:
            pos_inf = True
    else:
        terms.append((sc, mc, ec - fmt_acc.man_bits))
    if has_nan or (pos_inf and neg_inf):
        return nan_code(fmt_acc)
    if pos_inf or neg_inf:
        return int(inf_code(fmt_acc, 1 if neg_inf else 0))
    if not terms or all(m == 0 for _, m, _ in terms):
        all_neg = all(s == 1 for s, _, _ in terms) if terms else False
        return (1 << (fmt_acc.bits - 1)) if all_neg else 0
    qmin = min(q for _, m, q in terms if m != 0)
    total = 0
    for s, m, q in terms:
        if m != 0:
            total += (-m if s else m) << (q - qmin)
    if total == 0:
        return 0        # exact cancellation -> +0 (RNE)
    return _round_to_format(total, qmin, fmt_acc)


def dpa_exact(a_codes, b_codes, c_codes, fmt_ab, fmt_acc) -> np.ndarray:
    """Vector front-end: a/b (..., N), c (...,) integer code arrays."""
    a = np.asarray(a_codes)
    b = np.asarray(b_codes)
    c = np.asarray(c_codes)
    flat_a = a.reshape(-1, a.shape[-1])
    flat_b = b.reshape(-1, b.shape[-1])
    flat_c = c.reshape(-1)
    out = np.array([dpa_exact_code(fa, fb, fc, fmt_ab, fmt_acc)
                    for fa, fb, fc in zip(flat_a, flat_b, flat_c)],
                   dtype=np.uint32)
    return out.reshape(c.shape)
