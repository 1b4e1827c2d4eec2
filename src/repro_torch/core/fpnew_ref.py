"""FPnew-style baseline: sequential trans-precision FMA (port of
`repro.core.fpnew_ref`).

FPnew (the paper's baseline) has no DPA datapath: accumulating an
N-element low-precision dot product into FP32 issues N dependent FMAs,
each individually rounded (paper Fig. 1, "w/o DPA").  This module models
that execution contract bit-exactly by chaining the golden FMA
(`dpa_codes` with N=1 — the windowed datapath is correctly rounded for a
single product): the numerics baseline the paper motivates against (one
rounding per term vs one rounding total).
"""
from __future__ import annotations

import numpy as np

from .dpa import dpa_codes
from .formats import FP32, _int64, codes_to_np, float_to_codes, get_format


def fma_codes(a_codes, b_codes, c_codes, fmt_ab, fmt_acc=FP32):
    """Single correctly-rounded trans-precision FMA on codes (shape (...,))
    -> int64 codes in fmt_acc."""
    return dpa_codes(_int64(a_codes)[..., None], _int64(b_codes)[..., None],
                     c_codes, fmt_ab, fmt_acc)


def sequential_fma_codes(a_codes, b_codes, c_codes, fmt_ab, fmt_acc=FP32):
    """FPnew execution of an N-term dot product: N chained rounded FMAs.

    a_codes/b_codes: (..., N) codes in fmt_ab; c_codes: (...,) in fmt_acc.
    -> int64 codes in fmt_acc, on the inputs' device.
    """
    fmt_ab = get_format(fmt_ab)
    fmt_acc = get_format(fmt_acc)
    a_codes, b_codes = _int64(a_codes), _int64(b_codes)
    acc = c_codes
    for i in range(a_codes.shape[-1]):
        acc = dpa_codes(a_codes[..., i:i + 1], b_codes[..., i:i + 1], acc,
                        fmt_ab, fmt_acc)
    return acc


def sequential_fma(a, b, c, fmt_ab, fmt_acc=FP32):
    """Float front-end mirroring `repro_torch.core.dpa.dpa`."""
    fmt_ab = get_format(fmt_ab)
    fmt_acc = get_format(fmt_acc)
    ac = float_to_codes(np.asarray(a), fmt_ab)
    bc = float_to_codes(np.asarray(b), fmt_ab)
    cc = float_to_codes(np.asarray(c), fmt_acc)
    out = sequential_fma_codes(ac, bc, cc, fmt_ab, fmt_acc)
    return codes_to_np(out, fmt_acc).astype(np.float64)
