"""Grouped (per-expert) DPA matmuls: the plain PyTorch versions and the
wrappers around the CUDA kernels.

Replaces the Pallas TPU kernels `repro/kernels/dpa_grouped_matmul.py`
`dpa_grouped_matmul_fused` and `dpa_grouped_matmul_prequant`: the dense
contracts of `kernels.dpa_matmul`, one (M, K) x (K, N) product per
expert of an (E, M, K) x (E, K, N) stack.  The CUDA kernels are the
dense ones with the expert as grid dimension z (`csrc/dpa_matmul.cu`
`dpa_grouped_fused_launch`, the split-K route, or, at `fused_plan`'s
large M, the tiled route of `csrc/dpa_fused_tiled.cu`;
`csrc/dpa_prequant.cu` at E > 1).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import batched_rowwise_dot
from repro_torch.kernels import build, census
from repro_torch.kernels import dpa_matmul as DM


# -----------------------------------------------------------------------------
# fused quantize -> grouped matmul
# -----------------------------------------------------------------------------

def dpa_grouped_matmul_fused_ref(x, wq, sw, *, fmt_x: str, fmt_w: str,
                                 bk: int = DM.BK, pack_w: bool = False):
    """Plain version: the dense fused contract per expert, the experts
    as a batch dimension (each expert's rows sum in the dense plain
    version's order, so every expert slice equals it bit for bit)."""
    wt = DM.widen(wq, fmt_w, packed=pack_w, dim=1).transpose(1, 2)
    return DM.fused_blocks(x, wt, fmt_x, bk, batched_rowwise_dot) * sw.to(torch.float32)


def dpa_grouped_matmul_fused(x, wq, sw, *, fmt_x: str, fmt_w: str,
                             bk: int = DM.BK, pack_w: bool = False,
                             bn=None, split=None, verify: bool = False):
    """(E, M, K) raw x times pre-quantized expert weights wq ((E, K//2, N)
    packed fp4 or (E, K, N) fp8 codes) with (E, 1, N) column scales ->
    (E, M, N) f32.  `bn`, `split`: the split-K override (`fused_plan`).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_grouped_matmul_fused.launches` counts
    launches, `.<route>_launches` and `.<fmt_x>_launches` those of each
    route and activation format, `.verify_launches` those of a
    speculative verify pass (`verify`)."""
    build.forward_only("dpa_grouped_matmul_fused", x, wq, sw)
    DM.check_fused(x, wq, sw, pack_w,
                   lead=(x.shape[0],) if x.ndim == 3 else (-1,))
    if bn is not None or split is not None:
        DM.fused_plan(*x.shape, wq.shape[-1], bn=bn, split=split,
                      xb=DM.X_CODE_BYTES.get(fmt_x, 1))
    if x.device.type == "cpu":
        return dpa_grouped_matmul_fused_ref(x, wq, sw, fmt_x=fmt_x,
                                            fmt_w=fmt_w, bk=bk,
                                            pack_w=pack_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    E, M, K = x.shape
    N = wq.shape[-1]
    out = torch.empty((E, M, N), dtype=torch.float32, device=x.device)
    plan = DM.launch_fused(x, wq, sw, out, E, M, K, N, fmt_x=fmt_x,
                           fmt_w=fmt_w, pack_w=pack_w, bk=bk,
                           what="dpa_grouped_matmul_fused", bn=bn,
                           split=split)
    census.count(dpa_grouped_matmul_fused, census.launch_work(
        "dpa_grouped_matmul_fused", plan.route, E=E, M=M, K=K, N=N,
        x_bytes=x.element_size(), fmt_w=fmt_w, pack_w=pack_w, fmt_x=fmt_x),
        plan.route, fmt_x, *(("verify",) if verify else ()))
    return out


census.declare(dpa_grouped_matmul_fused, "splitk", "tiled", *DM.KERNEL_X,
               "verify")


# -----------------------------------------------------------------------------
# pre-quantized operand stacks
# -----------------------------------------------------------------------------

def dpa_grouped_matmul_prequant_ref(xq, wq, sx, sw, *, fmt_x: str,
                                    fmt_w: str, pack_x: bool = False,
                                    pack_w: bool = False):
    """Plain version: the dense prequant contract per expert — widen both
    code stacks, f32 sums over K, then `(acc * sx) * sw`."""
    x = DM.widen(xq, fmt_x, packed=pack_x, dim=-1)
    w = DM.widen(wq, fmt_w, packed=pack_w, dim=-2)
    acc = batched_rowwise_dot(x, w.transpose(1, 2))
    return acc * sx.to(torch.float32) * sw.to(torch.float32)


def dpa_grouped_matmul_prequant(xq, wq, sx, sw, *, fmt_x: str, fmt_w: str,
                                pack_x: bool = False, pack_w: bool = False,
                                bn=None, split=None):
    """(E, M, K') codes xq times (E, K', N) codes wq with (E, M, 1) row and
    (E, 1, N) column f32 scales -> (E, M, N) f32; K' = K / 2 on a packed
    side.  `bn`, `split`: the launch override (`prequant_plan`).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_grouped_matmul_prequant.launches` counts
    launches."""
    build.forward_only("dpa_grouped_matmul_prequant", xq, wq, sx, sw)
    E = xq.shape[0] if xq.ndim == 3 else -1
    M, K, N = DM.check_prequant(xq, wq, sx, sw, pack_x, pack_w, lead=(E,))
    kw = dict(fmt_x=fmt_x, fmt_w=fmt_w, pack_x=pack_x, pack_w=pack_w)
    if bn is not None or split is not None:
        DM.prequant_plan(E, M, K, N, bn=bn, split=split)
    if xq.device.type == "cpu":
        return dpa_grouped_matmul_prequant_ref(xq, wq, sx, sw, **kw)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    out = torch.empty((E, M, N), dtype=torch.float32, device=xq.device)
    DM.launch_prequant(xq, wq, sx, sw, out, E, M, K, N,
                       what="dpa_grouped_matmul_prequant", bn=bn,
                       split=split, **kw)
    census.count(dpa_grouped_matmul_prequant, census.launch_work(
        "dpa_grouped_matmul_prequant", E=E, M=M, K=K, N=N, **kw))
    return out


census.declare(dpa_grouped_matmul_prequant)
