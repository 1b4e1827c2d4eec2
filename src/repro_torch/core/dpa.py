"""TransDot golden model: trans-precision dot-product accumulation (DPA).

Port of `repro.core.dpa`, the bit-accurate functional model of the
TransDot datapath (paper §II): N low-precision products (N=1 scalar/SIMD
FMA, N=2 FP16, N=4 FP8-E4M3, N=8 FP4-E2M1) are computed *exactly*,
aligned into a wide windowed accumulator anchored at the maximum operand
exponent, summed together with a higher-precision addend C, normalized,
and rounded once (RNE) into the accumulate format (FP32 or FP16).

Datapath correspondence
-----------------------
  exact sub-multiplier products     -> integer mantissa products
  reconfigurable alignment shifter  -> per-term variable shift into the
                                       window, out-shifted bits -> a
                                       signed residue unit
  wide no-precision-loss adder      -> multi-limb integer accumulator of
                                       width 3*p_acc + 4 + ceil(log2(N+1))
  LZC + normalization shifter       -> exact bit-length scan + extraction
  rounding stage (per-lane)         -> single RNE encode

Everything is int64 torch arithmetic on the inputs' device, so the card
gives the CPU's codes bit for bit; no global switch is needed (the
reference enables JAX's x64 at import).  Shifts stay where int64 defines
them on every device: right shifts of negative limbs are arithmetic
(floor division), and no shift count reaches 63.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .formats import (FP32, FloatFormat, _int64, _shl1, codes_to_np,
                      decode, encode_from_parts, float_to_codes, get_format,
                      inf_code, nan_code)

# Number of 32-bit limbs in the wide accumulator (little-endian digits held
# in int64 so per-limb sums never overflow).
_LIMBS = 6
_MASK32 = (1 << 32) - 1


def default_window_bits(fmt_acc: FloatFormat, n_terms: int) -> int:
    """The paper's no-precision-loss adder width generalized to N terms."""
    return 3 * fmt_acc.precision + 4 + max(1, math.ceil(math.log2(n_terms + 1)))


# -----------------------------------------------------------------------------
# wide-integer helpers (radix 2^32 digits in int64)
# -----------------------------------------------------------------------------

def _place(limbs, mag, shift, sign):
    """limbs += (-1)^sign * mag * 2^shift   (shift >= 0, mag < 2^48)."""
    k = shift >> 5          # limb index
    rr = shift & 31         # intra-limb offset
    m_lo = mag & _MASK32
    m_hi = mag >> 32
    t0 = m_lo << rr                       # < 2^63
    t1 = m_hi << rr                       # < 2^47
    d = [t0 & _MASK32,
         (t0 >> 32) + (t1 & _MASK32),     # < 2^33
         t1 >> 32]
    s = 1 - 2 * sign
    pos = torch.arange(_LIMBS, dtype=torch.int64, device=limbs.device)
    for j, dj in enumerate(d):
        sel = (pos == (k + j)[..., None]).to(torch.int64)
        limbs = limbs + sel * (s * dj)[..., None]
    return limbs


def _carry_normalize(limbs):
    """Signed carry propagation -> digits in [0, 2^32), negative flag."""
    out = []
    carry = torch.zeros_like(limbs[..., 0])
    for j in range(_LIMBS):
        v = limbs[..., j] + carry
        carry = v >> 32          # arithmetic shift = floor division
        out.append(v - carry * (1 << 32))
    # after the top limb, `carry` is 0 (non-negative total) or -1 (negative)
    neg = carry < 0
    limbs = torch.stack(out, dim=-1)
    # two's-complement negate where negative: invert digits, +1 with carry
    inv = (~limbs) & _MASK32
    carry2 = torch.ones_like(limbs[..., 0])
    neg_digits = []
    for j in range(_LIMBS):
        v = inv[..., j] + carry2
        carry2 = v >> 32
        neg_digits.append(v & _MASK32)
    neg_limbs = torch.stack(neg_digits, dim=-1)
    return torch.where(neg[..., None], neg_limbs, limbs), neg


def _bitlen32(x):
    """Bit length of values in [0, 2^32)."""
    n = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        m = x >> k
        take = m != 0
        n = n + k * take.to(x.dtype)
        x = torch.where(take, m, x)
    return n + (x != 0).to(x.dtype)


def _msb(limbs):
    """Index+1 of the highest set bit; -1 if the value is zero."""
    pos = torch.arange(_LIMBS, dtype=limbs.dtype, device=limbs.device)
    cand = torch.where(limbs != 0, 32 * pos + _bitlen32(limbs), -1)
    return cand.amax(dim=-1)


def _get_limb(limbs, idx):
    idx_c = torch.clamp(idx, 0, _LIMBS - 1)
    v = torch.gather(limbs, -1, idx_c[..., None])[..., 0]
    return torch.where((idx < 0) | (idx >= _LIMBS), 0, v)


def _extract_top(limbs, msb, nbits):
    """T = floor(value / 2^(msb-nbits)), sticky = dropped bits != 0."""
    r = msb - nbits
    # r > 0 path: gather the straddling limbs
    k = torch.clamp_min(r, 0) >> 5
    rr = torch.clamp_min(r, 0) & 31
    l0 = _get_limb(limbs, k)
    l1 = _get_limb(limbs, k + 1)
    mask26 = (1 << (nbits + 1)) - 1
    # rr = 0 shifts l1 by 32: defined for int64 on every device
    t_pos = ((l0 >> rr) | ((l1 & mask26) << (32 - rr))) & ((1 << nbits) - 1)
    # sticky: limbs fully below k, plus low rr bits of limb k
    pos = torch.arange(_LIMBS, dtype=limbs.dtype, device=limbs.device)
    below = ((limbs != 0) & (pos < k[..., None])).any(dim=-1)
    sticky_pos = below | ((l0 & (_shl1(rr) - 1)) != 0)
    # r <= 0 path: value < 2^nbits, lives in limb 0 (nbits <= 27)
    # (where r > 0 the count is clamped to 0: the lane takes t_pos)
    t_neg = (limbs[..., 0] << torch.clamp(-r, 0, 32)) & ((1 << nbits) - 1)
    t = torch.where(r >= 0, t_pos, t_neg)
    sticky = (r > 0) & sticky_pos
    return t, sticky


# -----------------------------------------------------------------------------
# the DPA datapath
# -----------------------------------------------------------------------------

def dpa_codes(a_codes, b_codes, c_codes, fmt_ab, fmt_acc=FP32,
              window_bits=None):
    """N-term trans-precision dot-product accumulation on integer codes.

    a_codes, b_codes: integer codes of shape (..., N) in ``fmt_ab``.
    c_codes:          integer codes of shape (...,) in ``fmt_acc``.
    Tensors (any device) or numpy arrays (CPU).  Returns int64 codes of
    shape (...,) in ``fmt_acc``, on the inputs' device:
        round_RNE( sum_i a_i * b_i + c )   computed as one windowed sum.
    """
    fmt_ab = get_format(fmt_ab)
    fmt_acc = get_format(fmt_acc)
    a_codes = _int64(a_codes)
    dev = a_codes.device
    b_codes = _int64(b_codes).to(dev)
    c_codes = _int64(c_codes).to(dev)
    n_terms = a_codes.shape[-1]
    W = window_bits or default_window_bits(fmt_acc, n_terms)
    if W + 52 > 32 * _LIMBS:
        raise ValueError(f"window_bits={W} too wide for {_LIMBS} limbs")

    sa, ma, ea, za, ia, na = decode(a_codes, fmt_ab)
    sb, mb, eb, zb, ib, nb = decode(b_codes, fmt_ab)
    sc, mc, ec, zc, ic, nc = decode(c_codes, fmt_acc)

    # --- exact products ------------------------------------------------------
    sp = sa ^ sb
    mp = ma * mb                                     # <= 2^48 (fp32 scalar)
    qp = ea + eb - 2 * fmt_ab.man_bits
    mcw = mc
    qc = ec - fmt_acc.man_bits

    # --- anchor & window -----------------------------------------------------
    def blen(m):  # bit length of int64 magnitudes < 2^48
        hi = _bitlen32(m >> 32)
        lo = _bitlen32(m & _MASK32)
        return torch.where(hi > 0, hi + 32, lo)

    NEG = -(1 << 40)
    tops = torch.cat(
        [torch.where(mp != 0, qp + blen(mp), NEG),
         torch.where(mcw != 0, qc + blen(mcw), NEG)[..., None]], dim=-1)
    anchor = tops.amax(dim=-1)
    lam = anchor - W                                 # weight of window bit 0

    # --- align + accumulate (shifter + wide adder) ---------------------------
    # Window layout: bits [2, W+2) hold in-window data (weight 2^(lam+b-2));
    # bit 0 receives a SIGNED +-1 residue unit whenever a term loses bits
    # below the window — the end-around-borrow behaviour of a hardware
    # aligner, so a negative sub-window addend correctly breaks RNE ties
    # downward instead of acting as an unsigned sticky.
    limbs = torch.zeros(a_codes.shape[:-1] + (_LIMBS,), dtype=torch.int64,
                        device=dev)
    any_resid = torch.zeros(a_codes.shape[:-1], dtype=torch.bool, device=dev)

    def add_term(limbs, any_resid, m, q, s):
        sh = q - lam + 2
        # magnitudes are < 2^48, so a right shift of 62 already drops
        # every bit: the count stops there, where 1 << rs stays positive
        rs = torch.clamp(-sh, 0, 62)
        lost = (m & (_shl1(rs) - 1)) != 0
        m = m >> rs
        sh = torch.clamp(sh, 0, 32 * _LIMBS - 49)
        limbs = _place(limbs, m, sh, s)
        limbs = _place(limbs, lost.to(torch.int64), torch.zeros_like(sh), s)
        return limbs, any_resid | lost

    for i in range(n_terms):
        limbs, any_resid = add_term(limbs, any_resid,
                                    mp[..., i], qp[..., i], sp[..., i])
    limbs, any_resid = add_term(limbs, any_resid, mcw, qc, sc)

    # --- normalize + round ---------------------------------------------------
    limbs, neg = _carry_normalize(limbs)
    msb = _msb(limbs)
    is_zero = msb < 0
    nbits = fmt_acc.man_bits + 3                     # 1.man | G | R
    msb_c = torch.clamp_min(msb, 1)
    t, sticky = _extract_top(limbs, msb_c, nbits)
    e_lead = (lam - 2) + msb_c - 1                   # window floor at lam-2
    code = encode_from_parts(neg.to(torch.int64), t, e_lead, sticky, fmt_acc)

    # value exactly zero inside the window: sign = AND of all input signs
    # (IEEE-754 sum-of-zeros rule applied across the flattened sum); when
    # mixed-sign sub-window residues cancelled, the true value is an
    # unknowably-signed tiny -> +0 (documented 1-window-ulp contract).
    all_neg = (sp == 1).all(dim=-1) & (sc == 1)
    zero_code = (all_neg & ~any_resid).to(torch.int64) << (fmt_acc.bits - 1)
    code = torch.where(is_zero, zero_code, code)

    # --- special values ------------------------------------------------------
    prod_nan = na | nb | (ia & zb) | (ib & za)
    prod_inf = (ia | ib) & ~prod_nan
    pos_inf = (prod_inf & (sp == 0)).any(dim=-1) | (ic & (sc == 0))
    neg_inf = (prod_inf & (sp == 1)).any(dim=-1) | (ic & (sc == 1))
    any_nan = prod_nan.any(dim=-1) | nc | (pos_inf & neg_inf)
    any_inf = (pos_inf | neg_inf) & ~any_nan

    if fmt_acc.has_inf:
        code = torch.where(any_inf,
                           inf_code(fmt_acc, neg_inf.to(torch.int64)), code)
        code = torch.where(any_nan, nan_code(fmt_acc), code)
    else:
        code = torch.where(any_nan | any_inf, nan_code(fmt_acc), code)
    return code


# -----------------------------------------------------------------------------
# convenience float front-end (test / benchmark plumbing)
# -----------------------------------------------------------------------------

def dpa(a, b, c, fmt_ab, fmt_acc=FP32, window_bits=None):
    """DPA on float inputs: quantizes a/b into fmt_ab codes, c into
    fmt_acc (`float_to_codes`, the reference's casts), runs the datapath,
    returns the float64 numpy output."""
    fmt_ab = get_format(fmt_ab)
    fmt_acc = get_format(fmt_acc)
    ac = float_to_codes(np.asarray(a), fmt_ab)
    bc = float_to_codes(np.asarray(b), fmt_ab)
    cc = float_to_codes(np.asarray(c), fmt_acc)
    out = dpa_codes(ac, bc, cc, fmt_ab, fmt_acc, window_bits)
    return codes_to_np(out, fmt_acc).astype(np.float64)
