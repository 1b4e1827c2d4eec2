"""Absmax quantization onto the Table-I format grids (port of
`repro.core.quantize`).

Bit contract with the JAX reference as the engine runs it, under
`jax.jit`: XLA rewrites a division by a constant target (`amax / 448`)
into a multiply by the f32 reciprocal, so every constant-target scale
here is `amax * f32(1 / target)` (see `recip`).  A division by an array
scale (`x / scale`) stays a true IEEE division, as it does in XLA.

FP4 E2M1 values live in uint8 containers (one code per byte; nibble
packing is `core.packing`'s business).
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import get_format

_TORCH_DTYPE = {
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
    "fp8_e4m3": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
    "fp4_e2m1": torch.uint8,
}

_F32_TINY = 2.0 ** -126          # the f32-normal scale floor


def torch_dtype(fmt) -> torch.dtype:
    """Storage dtype for fmt (uint8 codes for fp4)."""
    return _TORCH_DTYPE[get_format(fmt).name]


def recip(target: float) -> float:
    """f32(1 / target) as XLA folds it: the reciprocal rounded once to
    f32 (exactly representable, so a f32 tensor times this Python float
    multiplies by exactly that f32)."""
    return float(np.float32(1.0) / np.float32(target))


# -----------------------------------------------------------------------------
# FP4-E2M1 arithmetic encode/decode
# -----------------------------------------------------------------------------

_FP4_MAGS = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)


def encode_fp4(x):
    """f32 values (pre-clipped to [-6, 6]) -> uint8 E2M1 codes, RNE.

    Midpoint thresholds with ties-to-even baked into the >/>= choices;
    -0.0 and NaN both encode to code 0, as in the reference."""
    s = (x < 0).to(torch.uint8)
    a = x.abs()
    code = torch.zeros(x.shape, dtype=torch.uint8, device=x.device)
    for i in range(1, 8):
        mid = 0.5 * (_FP4_MAGS[i - 1] + _FP4_MAGS[i])
        take = (a > mid) if (i - 1) % 2 == 0 else (a >= mid)
        code = torch.where(take, torch.full_like(code, i), code)
    return code | (s << 3)


def decode_fp4(codes):
    """uint8 E2M1 codes -> exact f32 values (code 8 decodes to -0.0)."""
    c = codes.to(torch.int32)
    s = (c >> 3) & 1
    e = (c >> 1) & 3
    m = (c & 1).to(torch.float32)
    p2 = torch.where(e == 3, 4.0, torch.where(e == 2, 2.0, 1.0))
    mag = torch.where(e == 0, 0.5 * m, (1.0 + 0.5 * m) * p2)
    return torch.where(s == 1, -mag, mag)


# -----------------------------------------------------------------------------
# scales and grids
# -----------------------------------------------------------------------------

def absmax_block_scale(xb, target: float, *, dim=1):
    """The kernels' block scale recipe: max(max(amax, 1e-30) *
    f32(1/target), 2^-126) over `dim` (kept)."""
    amax = xb.abs().amax(dim=dim, keepdim=True)
    return torch.clamp_min(torch.clamp_min(amax, 1e-30) * recip(target),
                           _F32_TINY)


def quant_rows_grid(x, fmt, *, dim=-1):
    """Absmax-quantize along `dim` onto fmt's value grid.

    -> (values-on-the-grid f32, f32 scale with `dim` kept) such that
    grid * scale is the dequantized tensor.  fmt "fp32" is the identity
    (grid = x, scale = 1)."""
    fmt = get_format(fmt)
    xf = x.to(torch.float32)
    if fmt.name == "fp32":
        return xf, torch.ones_like(xf.amax(dim=dim, keepdim=True))
    target = fmt.quant_target
    scale = absmax_block_scale(xf, target, dim=dim)
    y = torch.clamp(xf / scale, -target, target)
    if fmt.name == "fp4_e2m1":
        grid = decode_fp4(encode_fp4(y))
    else:
        grid = y.to(torch_dtype(fmt)).to(torch.float32)
    return grid, scale


def _all_dims(x, dim):
    return tuple(range(x.ndim)) if dim is None else dim


def compute_scale(x, fmt, *, dim=None, keepdim=True, eps=1e-30):
    """absmax / quant_target scale (as a reciprocal multiply), floored
    at the f32 normal range.  The eps clamp runs in x's dtype, like the
    reference's `jnp.maximum(amax, eps)`."""
    fmt = get_format(fmt)
    amax = x.abs().amax(dim=_all_dims(x, dim), keepdim=keepdim)
    scale = torch.clamp_min(amax, eps).to(torch.float32) \
        * recip(fmt.quant_target)
    return torch.clamp_min(scale, _F32_TINY)


def cast_to(x, fmt):
    """Saturating RNE cast into fmt (no scaling).  fp4 has no torch
    arithmetic dtype, so it returns the E2M1-rounded values as f32 (use
    `encode_fp4` for codes); zeros keep their sign, as a native float4
    cast does."""
    fmt = get_format(fmt)
    xf = torch.clamp(x.to(torch.float32), -fmt.max_finite, fmt.max_finite)
    if fmt.name == "fp4_e2m1":
        return torch.where(xf == 0, xf, decode_fp4(encode_fp4(xf)))
    return xf.to(torch_dtype(fmt))


def quantize(x, fmt, *, dim=None):
    """-> (q in fmt, f32 scale). dim None: per-tensor; else per-channel
    over the remaining dims."""
    scale = compute_scale(x, fmt, dim=dim)
    return cast_to(x.to(torch.float32) / scale, fmt), scale


def quantize_blockwise(x, fmt, *, dim, block):
    """Per-block scales along `dim` (block must divide the dim)."""
    dim = dim % x.ndim
    d = x.shape[dim]
    if d % block:
        raise ValueError(f"block {block} does not divide dim {d}")
    xb = x.reshape(x.shape[:dim] + (d // block, block) + x.shape[dim + 1:])
    scale = compute_scale(xb, fmt, dim=dim + 1)
    q = cast_to(xb.to(torch.float32) / scale, fmt)
    return q.reshape(x.shape), scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def dequantize_blockwise(q, scale, *, dim, block):
    dim = dim % q.ndim
    d = q.shape[dim]
    shp = q.shape[:dim] + (d // block, block) + q.shape[dim + 1:]
    return (q.reshape(shp).to(torch.float32) * scale).reshape(q.shape)


def quant_dequant(x, fmt, *, dim=None, block=None):
    fmt = get_format(fmt)
    if fmt.name == "fp32":
        return x
    if block is not None and dim is not None:
        q, s = quantize_blockwise(x, fmt, dim=dim, block=block)
        return dequantize_blockwise(q, s, dim=dim, block=block).to(x.dtype)
    q, s = quantize(x, fmt, dim=dim)
    return dequantize(q, s).to(x.dtype)


def fake_quant(x, fmt, *, dim=None, block=None):
    """Straight-through quantization: forward quant-dequant, backward
    identity."""
    if get_format(fmt).name == "fp32":
        return x
    qdq = quant_dequant(x, fmt, dim=dim, block=block)
    return x + (qdq - x).detach()
