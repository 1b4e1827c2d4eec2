"""Fused quantize -> DPA matmul: the plain PyTorch version and the
wrapper around the CUDA kernel (`csrc/dpa_matmul.cu`).

Replaces the Pallas TPU kernel `repro/kernels/dpa_matmul.py`
`dpa_matmul_fused`: raw (M, K) f32/bf16 activations are absmax-quantized
per (row, K block of 128) onto the E4M3 grid, each block's partial
product over pre-quantized weights is scaled by its row scale and added
into an f32 accumulator, and the weight column scales apply at the end.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import rowwise_dot
from repro_torch.core.formats import get_format
from repro_torch.core.packing import unpack_fp4_axis
from repro_torch.core.quantize import (absmax_block_scale, decode_fp4,
                                       encode_fp4, torch_dtype)
from repro_torch.kernels import build

BK = 128                     # the K block: part of the numerics contract
_KERNEL_W = {("fp4_e2m1", True): 0, ("fp8_e4m3", False): 1}


def widen(wq, fmt_w: str, *, pack_w: bool = False):
    """Weight codes -> f32 values (fp4 unpacked along K first)."""
    if fmt_w == "fp4_e2m1":
        return decode_fp4(unpack_fp4_axis(wq, 0) if pack_w else wq)
    return wq.to(torch.float32)


def dpa_matmul_fused_ref(x, wq, sw, *, fmt_x: str, fmt_w: str, bk: int = BK,
                         pack_w: bool = False):
    """Plain version: the semantic spec of the kernel (port of
    `repro.kernels.ref.dpa_matmul_fused_ref`), block by block.  Every
    product row sums in one fixed order (`rowwise_dot`), so row i does
    not depend on how many rows x has."""
    target = get_format(fmt_x).quant_target
    xf = x.to(torch.float32)
    wt = widen(wq, fmt_w, pack_w=pack_w).t()          # (N, K)
    out = torch.zeros((x.shape[0], wt.shape[0]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[1], bk):
        xb = xf[:, k0:k0 + bk]
        scale = absmax_block_scale(xb, target)
        y = torch.clamp(xb / scale, -target, target)
        if fmt_x == "fp4_e2m1":
            q = decode_fp4(encode_fp4(y))
        else:
            q = y.to(torch_dtype(fmt_x)).to(torch.float32)
        out = out + rowwise_dot(q, wt[:, k0:k0 + bk]) * scale
    return out * sw.to(torch.float32)


def _check(x, wq, sw, pack_w):
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be 2-D f32/bf16, got {x.dtype} {x.shape}")
    K, N = x.shape[1], wq.shape[1]
    if wq.ndim != 2 or wq.shape[0] * (2 if pack_w else 1) != K:
        raise ValueError(f"x {tuple(x.shape)} does not contract with wq "
                         f"{tuple(wq.shape)} (pack_w={pack_w})")
    if sw.shape != (1, N) or sw.dtype != torch.float32:
        raise ValueError(f"sw must be (1, {N}) f32, got {sw.dtype} "
                         f"{tuple(sw.shape)}")
    if not (x.device == wq.device == sw.device):
        raise ValueError("x, wq and sw must share one device")


def dpa_matmul_fused(x, wq, sw, *, fmt_x: str, fmt_w: str, bk: int = BK,
                     pack_w: bool = False):
    """(M, K) raw x times pre-quantized wq ((K//2, N) packed fp4 or
    (K, N) fp8 codes) with (1, N) column scales -> (M, N) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_matmul_fused.launches` counts launches."""
    _check(x, wq, sw, pack_w)
    if x.device.type == "cpu":
        return dpa_matmul_fused_ref(x, wq, sw, fmt_x=fmt_x, fmt_w=fmt_w,
                                    bk=bk, pack_w=pack_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w_fmt = _KERNEL_W.get((fmt_w, pack_w))
    if fmt_x != "fp8_e4m3" or w_fmt is None:
        raise NotImplementedError(
            f"dpa_matmul_fused kernel serves (fp8_e4m3, packed fp4_e2m1) and "
            f"(fp8_e4m3, fp8_e4m3); ({fmt_x}, {fmt_w}, pack_w={pack_w}) is "
            "ROADMAP Queue 2 item 1, other fmt pairs")
    M, K = x.shape
    N = wq.shape[1]
    if bk != BK or K % BK or N % 32:
        raise ValueError(f"kernel needs bk == {BK}, K % {BK} == 0 and "
                         f"N % 32 == 0; got bk={bk}, K={K}, N={N}")
    if fmt_w == "fp8_e4m3" and wq.dtype != torch.float8_e4m3fn:
        raise TypeError(f"fp8 weights must be float8_e4m3fn, got {wq.dtype}")
    if fmt_w == "fp4_e2m1" and wq.dtype != torch.uint8:
        raise TypeError(f"packed fp4 weights must be uint8, got {wq.dtype}")
    if not (x.is_contiguous() and wq.is_contiguous() and sw.is_contiguous()):
        raise ValueError("dpa_matmul_fused kernel needs contiguous operands")
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    err = lib.dpa_matmul_fused_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(), w_fmt,
        sw.data_ptr(), out.data_ptr(), M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dpa_matmul_fused")
    dpa_matmul_fused.launches += 1
    return out


dpa_matmul_fused.launches = 0
