"""Dense DPA matmuls: the plain PyTorch versions and the wrappers around
the CUDA kernels.

`dpa_matmul_fused` replaces the Pallas TPU kernel
`repro/kernels/dpa_matmul.py` `dpa_matmul_fused`: raw (M, K) f32/bf16
activations are absmax-quantized per (row, K block of 128) onto the E4M3
grid, each block's partial product over pre-quantized weights is scaled
by its row scale and added into an f32 accumulator, and the weight
column scales apply at the end.  `fused_plan` picks one of two routes by
shape: below `TILED_MIN_M` rows, `csrc/dpa_matmul.cu` ("splitk": swapped
fp16 tensor-core products, K split across a thread-block cluster whose
blocks share x's quantization; decode steps and prefill chunks); from it
on, `csrc/dpa_fused_tiled.cu`, the pre-pass `dpa_act_quant` (x quantized
once) and then a tiled product on the fp16 tensor cores.

`dpa_matmul_prequant` (`csrc/dpa_prequant.cu`) replaces
`dpa_matmul_prequant` of the same file: both operands arrive quantized
(codes plus per-row / per-column f32 scales), the codes' products sum
exactly (int8 tensor cores on the card), and the epilogue is
`(acc * sx) * sw`.  `prequant_plan` chooses its launch: the output
columns per block and the split of K across a thread-block cluster.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.device import batched_rowwise_dot, rowwise_dot
from repro_torch.core.formats import get_format
from repro_torch.core.packing import unpack_fp4_axis
from repro_torch.core.quantize import (absmax_block_scale, decode_fp4,
                                       encode_fp4, torch_dtype)
from repro_torch.kernels import build

BK = 128                     # the K block: part of the numerics contract
KERNEL_W = {("fp4_e2m1", True): 0, ("fp8_e4m3", False): 1}


def widen(codes, fmt: str, *, packed: bool = False, dim: int = 0):
    """Operand codes -> f32 values (fp4 unpacked along K, `dim`, first)."""
    if fmt == "fp4_e2m1":
        return decode_fp4(unpack_fp4_axis(codes, dim) if packed else codes)
    return codes.to(torch.float32)


def dpa_matmul_fused_ref(x, wq, sw, *, fmt_x: str, fmt_w: str, bk: int = BK,
                         pack_w: bool = False):
    """Plain version: the semantic spec of the kernel (port of
    `repro.kernels.ref.dpa_matmul_fused_ref`), block by block.  Every
    product row sums in one fixed order (`rowwise_dot`), so row i does
    not depend on how many rows x has."""
    wt = widen(wq, fmt_w, packed=pack_w).t()          # (N, K)
    return fused_blocks(x, wt, fmt_x, bk, rowwise_dot) * sw.to(torch.float32)


def fused_blocks(x, wt, fmt_x: str, bk: int, dot):
    """x (..., M, K) raw, wt (..., N, K) widened weights -> (..., M, N) f32
    before the column scales: per K block, the rows' absmax scales, the
    grid values, a fresh partial product `dot(q, wt_block)` scaled by the
    block's row scale and added into the running sum."""
    target = get_format(fmt_x).quant_target
    xf = x.to(torch.float32)
    out = torch.zeros(x.shape[:-1] + (wt.shape[-2],), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, x.shape[-1], bk):
        xb = xf[..., k0:k0 + bk]
        scale = absmax_block_scale(xb, target, dim=-1)
        y = torch.clamp(xb / scale, -target, target)
        if fmt_x == "fp4_e2m1":
            q = decode_fp4(encode_fp4(y))
        else:
            q = y.to(torch_dtype(fmt_x)).to(torch.float32)
        out = out + dot(q, wt[..., k0:k0 + bk]) * scale
    return out


def check_fused(x, wq, sw, pack_w, lead=()):
    """Operand checks shared by the dense and grouped fused wrappers:
    x (*lead, M, K) f32/bf16, wq (*lead, K', N), sw (*lead, 1, N) f32,
    one device."""
    nd = len(lead) + 2
    if x.ndim != nd or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be {nd}-D f32/bf16, got {x.dtype} "
                        f"{tuple(x.shape)}")
    K, N = x.shape[-1], wq.shape[-1]
    if wq.ndim != nd or tuple(x.shape[:-2]) != lead \
            or tuple(wq.shape[:-2]) != lead \
            or wq.shape[-2] * (2 if pack_w else 1) != K:
        raise ValueError(f"x {tuple(x.shape)} does not contract with wq "
                         f"{tuple(wq.shape)} (pack_w={pack_w})")
    if sw.shape != (*lead, 1, N) or sw.dtype != torch.float32:
        raise ValueError(f"sw must be {(*lead, 1, N)} f32, got {sw.dtype} "
                         f"{tuple(sw.shape)}")
    if not (x.device == wq.device == sw.device):
        raise ValueError("x, wq and sw must share one device")


# From this many rows per expert on, the tiled route: the smallest M of
# chip_smoke.py's sweep (M = 8 .. 512, PERF.md) at which it takes less
# device time than the split-K route over the two swept qwen3-4b shapes
# together (wg, N 9728, alone crosses over between 32 and 64 rows; wk, N
# 1024, between 256 and 512).  The engines' calls (decode steps of 8
# rows, prefill chunks of 32) stay on csrc/dpa_matmul.cu.
TILED_MIN_M = 128
TILE = 128                   # the tiled route's output tile, rows and columns
SMS = 132                    # H100 SXM streaming multiprocessors
MAX_CLUSTER = 8              # the portable thread-block cluster size
SMEM_LIMIT = 232448          # shared memory a block may use (227 KB)
# csrc/dpa_matmul.cu, the split-K route
SPLITK_COLS = (64, 32)       # output columns per block
SPLITK_ROWS = (8, 16, 32)    # rows per block
SPLITK_WARPS = 4             # each folds K blocks warp, warp + 4, ...
SPLITK_STAGE_ROWS = 64       # weight rows per ring stage
SPLITK_SLICE = 1280          # K per cluster rank the plan aims below
SPLITK_MIN_BLOCKS = 64       # ... and blocks it aims at, about half the SMs


def splitk_smem_bytes(bm: int, bn: int, K: int, split: int) -> int:
    """Shared memory of one split-K block (`smem_layout` of
    csrc/dpa_matmul.cu): bm rows of x as E4M3 codes over the K slice (row
    pitch K / split + 16 bytes), their block scales, the warps' weight
    rings (no deeper than a warp's K blocks fill, counted at E4M3
    weights' two stages a K block: at least the packed weights' need);
    then the cluster's receive slots."""
    ks = K // split
    slots = min({32: 4, 64: 3}[bn],
                -(-(ks // BK) // SPLITK_WARPS) * 2)
    ring = -(-(bm * (ks + 16) + ks // BK * bm * 4) // 16) * 16 \
        + SPLITK_WARPS * slots * SPLITK_STAGE_ROWS * (bn + 16)
    return (max(ring, SPLITK_WARPS * bm * bn * 4)
            + split * -(-bm * bn // split) * 4)


class FusedPlan(NamedTuple):
    """The fused kernel's launch: `route` "splitk" (`csrc/dpa_matmul.cu`:
    swapped fp16 MMAs, K split over a cluster of `split` blocks) or "tiled"
    (`csrc/dpa_fused_tiled.cu`, `split` 1), `bm` x `bn` outputs per block,
    `blocks` in the grid."""
    route: str
    bm: int
    bn: int
    split: int
    blocks: int


@functools.lru_cache(maxsize=None)
def splitk_cols(E: int, K: int, N: int):
    """The split-K route's (bn, split) from (E, K, N) alone — the split
    decides the bits of the fold, so no row's output depends on M.  64
    columns a block where that alone gives `SMS` column tiles, else 32;
    then the smallest split (a cluster size <= 8 dividing K / 128) that
    leaves each rank at most `SPLITK_SLICE` of K and brings the grid to
    `SPLITK_MIN_BLOCKS`, else the largest, among those whose block fits its
    shared memory at 8 rows (chip_smoke.py's sweep of every (bn, split)
    at the engines' shapes, PERF.md).  None where no split fits (K too
    long for the x slice in shared memory)."""
    splits = [s for s in range(1, MAX_CLUSTER + 1) if (K // BK) % s == 0]
    for bn in ((64, 32) if N % 64 == 0 and E * (N // 64) >= SMS else (32,)):
        fits = [s for s in splits
                if splitk_smem_bytes(8, bn, K, s) <= SMEM_LIMIT]
        if fits:
            return bn, next((s for s in fits if K // s <= SPLITK_SLICE
                             and E * (N // bn) * s >= SPLITK_MIN_BLOCKS),
                            fits[-1])
    return None


def splitk_rows(M: int, K: int, bn: int, split: int) -> int:
    """Rows per split-K block: the smallest tile holding M, else the
    largest, halved until the block fits its shared memory.  Any tile
    gives every row the same bits."""
    bm = next((r for r in SPLITK_ROWS if M <= r), SPLITK_ROWS[-1])
    while bm > 8 and splitk_smem_bytes(bm, bn, K, split) > SMEM_LIMIT:
        bm //= 2
    return bm


@functools.lru_cache(maxsize=None)
def fused_plan(E: int, M: int, K: int, N: int) -> FusedPlan:
    """The route by shape: "tiled" from `TILED_MIN_M` rows per expert on
    (or where no split-K launch fits), else "splitk" with `splitk_cols`'
    (bn, split) and `splitk_rows`' rows.  Raises for what no route takes:
    K not a positive multiple of 128, N not a positive multiple of 32, E
    outside [1, 65535], M < 1.  Memoized."""
    if K <= 0 or K % BK:
        raise ValueError(f"fused kernel needs K % {BK} == 0, K > 0; got "
                         f"K={K}")
    if N <= 0 or N % SPLITK_COLS[-1]:
        raise ValueError(f"fused kernel needs N % {SPLITK_COLS[-1]} == 0, "
                         f"N > 0; got N={N}")
    if not 1 <= E <= 65535 or M < 1:
        raise ValueError(f"fused kernel needs 1 <= E <= 65535 and M >= 1; "
                         f"got E={E}, M={M}")
    cols = splitk_cols(E, K, N)
    if M >= TILED_MIN_M or cols is None:
        return FusedPlan("tiled", TILE, TILE, 1,
                         E * -(-M // TILE) * -(-N // TILE))
    bn, split = cols
    bm = splitk_rows(M, K, bn, split)
    return FusedPlan("splitk", bm, bn, split,
                     E * -(-M // bm) * (N // bn) * split)


def launch_fused(x, wq, sw, out, E, M, K, N, *, fmt_x, fmt_w, pack_w, bk,
                 what) -> FusedPlan:
    """Launch the shape's `fused_plan` route on CUDA operands (E = 1
    dense), or raise for what the kernels do not serve.  -> the plan."""
    w_fmt = KERNEL_W.get((fmt_w, pack_w))
    if fmt_x != "fp8_e4m3" or w_fmt is None:
        raise NotImplementedError(
            f"{what} kernel serves (fp8_e4m3, packed fp4_e2m1) and "
            f"(fp8_e4m3, fp8_e4m3); ({fmt_x}, {fmt_w}, pack_w={pack_w}) is "
            "open in ROADMAP Queue 2 under dpa_matmul_fused (formats open)")
    if bk != BK:
        raise ValueError(f"kernel needs bk == {BK}; got bk={bk}")
    plan = fused_plan(E, M, K, N)
    if fmt_w == "fp8_e4m3" and wq.dtype != torch.float8_e4m3fn:
        raise TypeError(f"fp8 weights must be float8_e4m3fn, got {wq.dtype}")
    if fmt_w == "fp4_e2m1" and wq.dtype != torch.uint8:
        raise TypeError(f"packed fp4 weights must be uint8, got {wq.dtype}")
    if not (x.is_contiguous() and wq.is_contiguous() and sw.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous operands")
    aligned = (x, wq, sw, out) if plan.route == "tiled" else (x, wq)
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{what} {plan.route} route needs 16-byte aligned "
                         "operands")
    lib = build.load_library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "tiled":
        codes, scales = dpa_act_quant(x)
        err = lib.dpa_fused_tiled_launch(
            codes.data_ptr(), scales.data_ptr(), wq.data_ptr(), w_fmt,
            sw.data_ptr(), out.data_ptr(), E, M, K, N, stream)
    else:
        err = lib.dpa_grouped_fused_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), wq.data_ptr(),
            w_fmt, sw.data_ptr(), out.data_ptr(), E, M, K, N, plan.bm,
            plan.bn, plan.split, stream)
    build.check(err, what)
    return plan


def dpa_matmul_fused(x, wq, sw, *, fmt_x: str, fmt_w: str, bk: int = BK,
                     pack_w: bool = False):
    """(M, K) raw x times pre-quantized wq ((K//2, N) packed fp4 or
    (K, N) fp8 codes) with (1, N) column scales -> (M, N) f32.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_matmul_fused.launches` counts launches."""
    check_fused(x, wq, sw, pack_w)
    if x.device.type == "cpu":
        return dpa_matmul_fused_ref(x, wq, sw, fmt_x=fmt_x, fmt_w=fmt_w,
                                    bk=bk, pack_w=pack_w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    M, K = x.shape
    N = wq.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    plan = launch_fused(x, wq, sw, out, 1, M, K, N, fmt_x=fmt_x,
                        fmt_w=fmt_w, pack_w=pack_w, bk=bk,
                        what="dpa_matmul_fused")
    dpa_matmul_fused.launches += 1
    dpa_matmul_fused.tiled_launches += plan.route == "tiled"
    dpa_matmul_fused.splitk_launches += plan.route == "splitk"
    return out


dpa_matmul_fused.launches = 0
dpa_matmul_fused.tiled_launches = 0
dpa_matmul_fused.splitk_launches = 0


# -----------------------------------------------------------------------------
# the tiled route's two stages
# -----------------------------------------------------------------------------

def dpa_act_quant_ref(x, bk: int = BK):
    """Plain version of the tiled route's pre-pass: x (..., M, K) f32/bf16
    -> (E4M3 codes (..., M, K) uint8, scales (..., M, K / bk) f32), the
    per-(row, K block) quantization of `fused_blocks`."""
    target = get_format("fp8_e4m3").quant_target
    xb = x.to(torch.float32).unflatten(-1, (x.shape[-1] // bk, bk))
    scale = absmax_block_scale(xb, target, dim=-1)
    y = torch.clamp(xb / scale, -target, target)
    codes = y.to(torch.float8_e4m3fn).view(torch.uint8).flatten(-2)
    return codes, scale.squeeze(-1)


def dpa_act_quant(x, bk: int = BK):
    """Stage one of the tiled route (`csrc/dpa_fused_tiled.cu`
    `act_quant_kernel`): x (..., M, K) quantized once per (row, K block).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_act_quant.launches` counts launches."""
    if x.device.type == "cpu":
        return dpa_act_quant_ref(x, bk)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    K = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim < 2:
        raise TypeError(f"x must be f32/bf16 (..., M, K), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if bk != BK or K % BK or K == 0:
        raise ValueError(f"kernel needs bk == {BK} and K % {BK} == 0; got "
                         f"bk={bk}, K={K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("dpa_act_quant needs contiguous 16-byte aligned x")
    codes = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (K // BK,), dtype=torch.float32,
                         device=x.device)
    err = build.load_library().dpa_act_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scales.data_ptr(), x.numel() // K, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dpa_act_quant")
    dpa_act_quant.launches += 1
    return codes, scales


dpa_act_quant.launches = 0


def dpa_fused_tiled_ref(codes, scales, wq, sw, *, fmt_w: str,
                        pack_w: bool = False, bk: int = BK):
    """Plain version of the tiled route's product: E4M3 codes (..., M, K)
    and scales (..., M, K / bk) of `dpa_act_quant`, times wq (..., K', N)
    with column scales sw (..., 1, N), per K block a fresh partial scaled
    by its row scale and added into the running sum.  Equals
    `dpa_matmul_fused_ref` (dense) and `dpa_grouped_matmul_fused_ref`
    (an expert stack) on the raw x bit for bit."""
    wt = widen(wq, fmt_w, packed=pack_w, dim=-2).transpose(-1, -2)
    dot = rowwise_dot if codes.ndim == 2 else batched_rowwise_dot
    q = codes.view(torch.float8_e4m3fn).to(torch.float32)
    out = torch.zeros(codes.shape[:-1] + (wt.shape[-2],),
                      dtype=torch.float32, device=codes.device)
    for i, k0 in enumerate(range(0, codes.shape[-1], bk)):
        out = out + dot(q[..., k0:k0 + bk], wt[..., k0:k0 + bk]) \
            * scales[..., i:i + 1]
    return out * sw.to(torch.float32)


# -----------------------------------------------------------------------------
# pre-quantized operands
# -----------------------------------------------------------------------------

def dpa_matmul_prequant_ref(xq, wq, sx, sw, *, fmt_x: str, fmt_w: str,
                            pack_x: bool = False, pack_w: bool = False):
    """Plain version (port of the reference kernel's contract): widen both
    code operands, f32 products summed over K in one fixed order, then
    `(acc * sx) * sw`.  For fp4 x fp4 every partial sum is exact, so any
    order gives the same bits."""
    x = widen(xq, fmt_x, packed=pack_x, dim=-1)
    w = widen(wq, fmt_w, packed=pack_w, dim=-2)
    acc = rowwise_dot(x, w.t())
    return acc * sx.to(torch.float32) * sw.to(torch.float32)


def check_prequant(xq, wq, sx, sw, pack_x, pack_w, lead=()):
    """Operand checks shared by the dense and grouped prequant wrappers:
    xq (*lead, M, K'), wq (*lead, K', N), sx (*lead, M, 1), sw (*lead, 1,
    N), f32 scales, one device."""
    nd = len(lead) + 2
    if xq.ndim != nd or wq.ndim != nd or tuple(xq.shape[:-2]) != lead \
            or tuple(wq.shape[:-2]) != lead:
        raise ValueError(f"xq {tuple(xq.shape)} and wq {tuple(wq.shape)} "
                         f"must be {nd}-D with leading dims {lead}")
    M, N = xq.shape[-2], wq.shape[-1]
    K = xq.shape[-1] * (2 if pack_x else 1)
    if wq.shape[-2] * (2 if pack_w else 1) != K:
        raise ValueError(f"xq {tuple(xq.shape)} does not contract with wq "
                         f"{tuple(wq.shape)} (pack_x={pack_x}, "
                         f"pack_w={pack_w})")
    if sx.shape != (*lead, M, 1) or sw.shape != (*lead, 1, N) \
            or sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError(f"sx must be {(*lead, M, 1)} and sw {(*lead, 1, N)}"
                         f" f32; got {sx.dtype} {tuple(sx.shape)}, "
                         f"{sw.dtype} {tuple(sw.shape)}")
    if not (xq.device == wq.device == sx.device == sw.device):
        raise ValueError("xq, wq, sx and sw must share one device")
    return M, K, N


COL_TILES = (64, 32, 16)     # output columns per block, widest first
ROW_TILES = (8, 16, 32, 64)  # rows per block
MAX_TILE = 2048              # rows x columns a block: 64 int32 sums a thread
K_EXACT = 2 ** 16            # K below it: |4 acc| <= 144 K < 2^24, exact


class PrequantPlan(NamedTuple):
    """The prequant kernel's launch: `bn` output columns and `row_tile`
    rows per block, K split over a cluster of `split` blocks, `blocks` in
    the grid (E x row tiles x N / bn x split)."""
    bn: int
    split: int
    row_tile: int
    blocks: int


@functools.lru_cache(maxsize=None)
def prequant_plan(E: int, M: int, K: int, N: int) -> PrequantPlan:
    """The smallest split (a cluster size <= 8 dividing K / 128), and at
    it the widest column tile (rows x columns <= `MAX_TILE`), that bring
    the grid to `SMS` blocks; where none does, 16 columns at the largest
    split.  Raises for what the kernel cannot take exactly: K not a
    positive multiple of 128 or not below 2^16, N not a multiple of 16,
    E outside [1, 65535], M < 1.  Memoized: one lookup per call."""
    if K <= 0 or K % BK or K >= K_EXACT:
        raise ValueError(f"prequant kernel needs 0 < K < {K_EXACT} with K % "
                         f"{BK} == 0 (int32 sums exact in f32); got K={K}")
    if N <= 0 or N % COL_TILES[-1]:
        raise ValueError(f"prequant kernel needs N % {COL_TILES[-1]} == 0; "
                         f"got N={N}")
    if not 1 <= E <= 65535 or M < 1:
        raise ValueError(f"prequant kernel needs 1 <= E <= 65535 and M >= 1;"
                         f" got E={E}, M={M}")
    row_tile = next((t for t in ROW_TILES if M <= t), ROW_TILES[-1])
    tiles = E * -(-M // row_tile)
    splits = [s for s in range(1, MAX_CLUSTER + 1) if (K // BK) % s == 0]
    for split in splits:
        for bn in COL_TILES:
            blocks = tiles * (N // bn) * split
            if N % bn == 0 and bn * row_tile <= MAX_TILE and blocks >= SMS:
                return PrequantPlan(bn, split, row_tile, blocks)
    bn = COL_TILES[-1]
    return PrequantPlan(bn, splits[-1], row_tile,
                        tiles * (N // bn) * splits[-1])


def launch_prequant(xq, wq, sx, sw, out, E, M, K, N, *, fmt_x, fmt_w,
                    pack_x, pack_w, what):
    """Launch `csrc/dpa_prequant.cu` on CUDA operands (E = 1 dense) with
    the shape's `prequant_plan`, or raise for what the kernel does not
    serve."""
    if (fmt_x, fmt_w, pack_x, pack_w) != ("fp4_e2m1", "fp4_e2m1", True,
                                         True):
        raise NotImplementedError(
            f"{what} kernel serves packed fp4_e2m1 x packed fp4_e2m1; "
            f"({fmt_x}, {fmt_w}, pack_x={pack_x}, pack_w={pack_w}) is "
            "open in ROADMAP Queue 2 under dpa_matmul_prequant (formats "
            "open)")
    plan = prequant_plan(E, M, K, N)
    if xq.dtype != torch.uint8 or wq.dtype != torch.uint8:
        raise TypeError(f"packed fp4 operands must be uint8, got {xq.dtype} "
                        f"and {wq.dtype}")
    if not all(t.is_contiguous() for t in (xq, wq, sx, sw)):
        raise ValueError(f"{what} kernel needs contiguous operands")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs 16-byte aligned codes")
    lib = build.load_library()
    err = lib.dpa_prequant_launch(
        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
        out.data_ptr(), E, M, K, N, plan.bn, plan.split,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, what)


def dpa_matmul_prequant(xq, wq, sx, sw, *, fmt_x: str, fmt_w: str,
                        pack_x: bool = False, pack_w: bool = False):
    """(M, K') codes xq times (K', N) codes wq with (M, 1) row and (1, N)
    column f32 scales -> (M, N) f32; K' = K / 2 on a packed side.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_matmul_prequant.launches` counts launches."""
    M, K, N = check_prequant(xq, wq, sx, sw, pack_x, pack_w)
    kw = dict(fmt_x=fmt_x, fmt_w=fmt_w, pack_x=pack_x, pack_w=pack_w)
    if xq.device.type == "cpu":
        return dpa_matmul_prequant_ref(xq, wq, sx, sw, **kw)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    launch_prequant(xq, wq, sx, sw, out, 1, M, K, N, what="dpa_matmul_prequant",
                    **kw)
    dpa_matmul_prequant.launches += 1
    return out


dpa_matmul_prequant.launches = 0
