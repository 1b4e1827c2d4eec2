"""Row quantizers: the plain PyTorch versions and the wrappers around the
CUDA kernel (`csrc/quantize_rows.cu`).

`quantize_rows` replaces the Pallas TPU kernel `repro/kernels/quantize.py`
`quantize_rows`: per-row absmax scale, `clip(x / scale, +-target)` and a
saturating cast onto the format's grid (native E4M3 / fp16 / bf16 codes,
or one uint8 E2M1 code per element).  `quantize_pack_rows` replaces
`quantize_pack_rows` of the same file: the E2M1 codes packed two per
byte along K, low nibble = even index.  Codes and scales of kernel and
plain version are bit-identical.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.packing import pack_fp4
from repro_torch.core.quantize import (cast_to, compute_scale, encode_fp4,
                                       torch_dtype)
from repro_torch.kernels import build

# the kernel's format codes (2 is packed E2M1)
_KERNEL_FMT = {"fp8_e4m3": 0, "fp4_e2m1": 1, "fp16": 3, "bf16": 4}
_PACKED_FP4 = 2


def quantize_rows_ref(x, *, fmt: str):
    """Plain version (port of `repro.kernels.ref.quantize_rows_ref`):
    (M, K) -> (codes, (M, 1) f32 scales), the scale `compute_scale`'s
    `amax * f32(1/target)` over each row of the f32 values."""
    f = get_format(fmt)
    xf = x.to(torch.float32)
    scale = compute_scale(xf, f, dim=1)
    y = xf / scale
    if f.name == "fp4_e2m1":
        return encode_fp4(torch.clamp(y, -f.max_finite, f.max_finite)), scale
    return cast_to(y, f), scale


def quantize_pack_rows_ref(x):
    """Plain version of the packing quantizer: E2M1 codes of
    `quantize_rows_ref`, two per byte along K."""
    q, scale = quantize_rows_ref(x, fmt="fp4_e2m1")
    return pack_fp4(q), scale


def _check(x, pack: bool):
    if x.ndim != 2 or not x.is_floating_point():
        raise TypeError(f"x must be a 2-D float matrix, got {x.dtype} "
                        f"{tuple(x.shape)}")
    if pack and x.shape[1] % 2:
        raise ValueError(f"fp4 packing needs an even K, got {x.shape[1]}")


def _launch(x, codes, kernel_fmt: int, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32/bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    M, K = x.shape
    scales = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = build.load_library().quantize_rows_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scales.data_ptr(), M, K, kernel_fmt,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)
    return codes, scales


def quantize_rows(x, *, fmt: str):
    """(M, K) f32/bf16 -> (codes (M, K) in fmt's dtype, or uint8 E2M1
    codes, scales (M, 1) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `quantize_rows.launches` counts launches."""
    _check(x, False)
    if x.device.type == "cpu":
        return quantize_rows_ref(x, fmt=fmt)
    name = get_format(fmt).name
    if name not in _KERNEL_FMT:
        raise NotImplementedError(
            f"quantize_rows kernel serves {sorted(_KERNEL_FMT)}; {fmt} is "
            "open in ROADMAP Queue 2 under quantize_rows (formats open)")
    codes = torch.empty(x.shape, dtype=torch_dtype(name), device=x.device)
    out = _launch(x, codes, _KERNEL_FMT[name], "quantize_rows")
    quantize_rows.launches += 1
    return out


quantize_rows.launches = 0


def quantize_pack_rows(x):
    """(M, K) f32/bf16 -> (packed E2M1 codes (M, K / 2) uint8, scales (M,
    1) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `quantize_pack_rows.launches` counts launches."""
    _check(x, True)
    if x.device.type == "cpu":
        return quantize_pack_rows_ref(x)
    M, K = x.shape
    codes = torch.empty((M, K // 2), dtype=torch.uint8, device=x.device)
    out = _launch(x, codes, _PACKED_FP4, "quantize_pack_rows")
    quantize_pack_rows.launches += 1
    return out


quantize_pack_rows.launches = 0
