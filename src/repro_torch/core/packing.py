"""Bit packing for sub-byte formats (port of `repro.core.packing`).

FP4 packs two E2M1 codes per byte: the low nibble holds the even index,
the high nibble the odd one.
"""
from __future__ import annotations

import torch

from .formats import get_format


def pack_fp4(codes):
    """uint8 codes in [0,16) with an even last dim -> packed uint8."""
    c = codes.to(torch.uint8)
    if c.shape[-1] % 2:
        raise ValueError("fp4 packing needs an even trailing dimension")
    return (c[..., 0::2] & 0xF) | ((c[..., 1::2] & 0xF) << 4)


def unpack_fp4(packed):
    p = packed.to(torch.uint8)
    out = torch.stack([p & 0xF, p >> 4], dim=-1)
    return out.reshape(p.shape[:-1] + (p.shape[-1] * 2,))


def pack_fp4_axis(codes, dim: int):
    """Pack two E2M1 codes per byte along `dim` (weights pack along K,
    their dim 0)."""
    dim = dim % codes.ndim
    return pack_fp4(codes.movedim(dim, -1)).movedim(-1, dim).contiguous()


def unpack_fp4_axis(packed, dim: int):
    dim = dim % packed.ndim
    return unpack_fp4(packed.movedim(dim, -1)).movedim(-1, dim).contiguous()


def packed_nbytes(n_elems: int, fmt) -> int:
    fmt = get_format(fmt)
    if fmt.bits == 4:
        return (n_elems + 1) // 2
    return n_elems * ((fmt.bits + 7) // 8)


def operand_nbytes(n_elems: int, fmt, *, packed: bool = True) -> int:
    """Bytes one operand tensor moves at format width (`packed=False`:
    one byte per fp4 code)."""
    fmt = get_format(fmt)
    if fmt.bits == 4 and not packed:
        return n_elems
    return packed_nbytes(n_elems, fmt)
