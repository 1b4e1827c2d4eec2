"""Dense DPA matmuls: the plain PyTorch versions and the wrappers around
the CUDA kernels.

`dpa_matmul_fused` replaces the Pallas TPU kernel
`repro/kernels/dpa_matmul.py` `dpa_matmul_fused`: raw (M, K) f32/bf16
activations are absmax-quantized per (row, K block of 128) onto the
`fmt_x` grid (E4M3, E2M1 or fp16 on the card: `KERNEL_X`), each block's
partial product over pre-quantized weights is scaled
by its row scale and added into an f32 accumulator, and the weight
column scales apply at the end.  `fused_plan` picks one of two routes by
shape: below `TILED_MIN_M` rows, `csrc/dpa_matmul.cu` ("splitk": swapped
fp16 tensor-core products, K split across a thread-block cluster whose
blocks share x's quantization; decode steps and prefill chunks); from it
on, `csrc/dpa_fused_tiled.cu`, the pre-pass `dpa_act_quant` (x quantized
once) and then a tiled product on the fp16 tensor cores.

`dpa_matmul_prequant` (`csrc/dpa_prequant.cu`) replaces
`dpa_matmul_prequant` of the same file: both operands arrive quantized
(codes plus per-row / per-column f32 scales; fp16, bf16, E4M3, E5M2 or
E2M1, packed or one code a byte, each side its own), the products are
exact, the sum f32 (on the card: int8 tensor cores for E2M1 x E2M1, whose
sums are exact too, else fp16 or bf16 ones), and the epilogue is
`(acc * sx) * sw`.  `prequant_plan` chooses its launch: the output
columns per block and the split of K across a thread-block cluster.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.device import batched_rowwise_dot, rowwise_dot
from repro_torch.core.formats import get_format, torch_dtype
from repro_torch.core.packing import unpack_fp4_axis
from repro_torch.core.quantize import (absmax_block_scale, decode_fp4,
                                       encode_fp4)
from repro_torch.kernels import build, census

BK = 128                     # the K block: part of the numerics contract
KERNEL_W = {("fp4_e2m1", True): 0, ("fp8_e4m3", False): 1}
# the activation formats the fused kernels quantize onto (their grid
# codes), and the bytes of a code the kernels hold (E2M1 values as E4M3
# bytes: every E2M1 value is an E4M3 value)
KERNEL_X = {f: build.GRID_CODES[f] for f in ("fp8_e4m3", "fp4_e2m1", "fp16")}
X_CODE_BYTES = {f: census.CODE_BYTES[f] for f in KERNEL_X}
# the ROADMAP item naming what the fused kernels do not serve yet
FUSED_FORMATS_ITEM = ("ROADMAP Queue 2 under dpa_matmul_fused (formats "
                      "open: bf16 and E5M2 activations, weights other than "
                      "packed E2M1 and E4M3)")


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


def splitk_smem_bytes(bm: int, bn: int, K: int, split: int,
                      xb: int = 1) -> int:
    """Shared memory of one split-K block (`smem_layout` of
    csrc/dpa_matmul.cuh): bm rows of x as codes of xb bytes (E4M3 bytes 1,
    fp16 2) over the K slice (row pitch xb (K / split + 16) bytes), their
    block scales, the warps' weight
    rings (no deeper than a warp's K blocks fill, counted at E4M3
    weights' two stages a K block: at least the packed weights' need);
    then the cluster's receive slots."""
    ks = K // split
    slots = min({32: 4, 64: 3}[bn],
                -(-(ks // BK) // SPLITK_WARPS) * 2)
    ring = -(-(bm * xb * (ks + 16) + ks // BK * bm * 4) // 16) * 16 \
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
def splitk_cols(E: int, K: int, N: int, xb: int = 1):
    """The split-K route's (bn, split) from (E, K, N) and the x code's
    bytes alone — the split decides the bits of the fold, so no row's
    output depends on M.  64
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
                if splitk_smem_bytes(8, bn, K, s, xb) <= SMEM_LIMIT]
        if fits:
            return bn, next((s for s in fits if K // s <= SPLITK_SLICE
                             and E * (N // bn) * s >= SPLITK_MIN_BLOCKS),
                            fits[-1])
    return None


def splitk_rows(M: int, K: int, bn: int, split: int, xb: int = 1) -> int:
    """Rows per split-K block: the smallest tile holding M, else the
    largest, halved until the block fits its shared memory.  Any tile
    gives every row the same bits."""
    bm = next((r for r in SPLITK_ROWS if M <= r), SPLITK_ROWS[-1])
    while bm > 8 and splitk_smem_bytes(bm, bn, K, split, xb) > SMEM_LIMIT:
        bm //= 2
    return bm


def fused_plan(E: int, M: int, K: int, N: int, *, bn=None,
               split=None, xb: int = 1) -> FusedPlan:
    """The route by shape: "tiled" from `TILED_MIN_M` rows per expert on
    (or where no split-K launch fits), else "splitk" with `splitk_cols`'
    (bn, split) and `splitk_rows`' rows.  Raises for what no route takes:
    K not a positive multiple of 128, N not a positive multiple of 32, E
    outside [1, 65535], M < 1.  The automatic plan is memoized.

    `bn` and `split` (both or neither) override the split-K route's
    (bn, split), as the tuner's measured plans do; like the automatic
    choice they do not depend on M.  An override passes the automatic
    plan's checks or raises `ValueError`: bn one of `SPLITK_COLS` dividing
    N, split at most `MAX_CLUSTER` dividing K / 128, the block at 8 rows
    within `SMEM_LIMIT`.  From `TILED_MIN_M` rows on the tiled route
    serves, which has no such knobs.  `xb`: the bytes of an x code in
    shared memory (`X_CODE_BYTES`: 2 for fp16 activations)."""
    if bn is None and split is None:
        return _auto_fused_plan(E, M, K, N, xb)
    _check_fused_shape(E, M, K, N)
    if bn is None or split is None:
        raise ValueError(f"a split-K override takes bn and split together; "
                         f"got bn={bn}, split={split}")
    bn, split = int(bn), int(split)
    if bn not in SPLITK_COLS or N % bn:
        raise ValueError(f"split-K bn must be one of {SPLITK_COLS} dividing "
                         f"N={N}; got {bn}")
    if not 1 <= split <= MAX_CLUSTER or (K // BK) % split:
        raise ValueError(f"split-K split must be 1..{MAX_CLUSTER} dividing "
                         f"K / {BK} = {K // BK}; got {split}")
    if splitk_smem_bytes(8, bn, K, split, xb) > SMEM_LIMIT:
        raise ValueError(f"split-K block (8 rows, bn {bn}, split {split}) "
                         f"needs more than {SMEM_LIMIT} bytes of shared "
                         f"memory at K={K}")
    return _fused_route(E, M, K, N, (bn, split), xb)


def _check_fused_shape(E, M, K, N):
    if K <= 0 or K % BK:
        raise ValueError(f"fused kernel needs K % {BK} == 0, K > 0; got "
                         f"K={K}")
    if N <= 0 or N % SPLITK_COLS[-1]:
        raise ValueError(f"fused kernel needs N % {SPLITK_COLS[-1]} == 0, "
                         f"N > 0; got N={N}")
    if not 1 <= E <= 65535 or M < 1:
        raise ValueError(f"fused kernel needs 1 <= E <= 65535 and M >= 1; "
                         f"got E={E}, M={M}")


def _fused_route(E, M, K, N, cols, xb=1) -> FusedPlan:
    if M >= TILED_MIN_M or cols is None:
        return FusedPlan("tiled", TILE, TILE, 1,
                         E * -(-M // TILE) * -(-N // TILE))
    bn, split = cols
    bm = splitk_rows(M, K, bn, split, xb)
    return FusedPlan("splitk", bm, bn, split,
                     E * -(-M // bm) * (N // bn) * split)


@functools.lru_cache(maxsize=None)
def _auto_fused_plan(E: int, M: int, K: int, N: int, xb: int = 1
                     ) -> FusedPlan:
    _check_fused_shape(E, M, K, N)
    return _fused_route(E, M, K, N, splitk_cols(E, K, N, xb), xb)


# the memo is the automatic path's alone
fused_plan.cache_info = _auto_fused_plan.cache_info
fused_plan.cache_clear = _auto_fused_plan.cache_clear


def launch_fused(x, wq, sw, out, E, M, K, N, *, fmt_x, fmt_w, pack_w, bk,
                 what, bn=None, split=None) -> FusedPlan:
    """Launch the shape's `fused_plan` route on CUDA operands (E = 1
    dense), with the split-K override (bn, split) where given, or raise
    for what the kernels do not serve.  -> the plan."""
    w_fmt = KERNEL_W.get((fmt_w, pack_w))
    if fmt_x not in KERNEL_X or w_fmt is None:
        raise NotImplementedError(
            f"{what} kernel serves {sorted(KERNEL_X)} activations times "
            f"packed fp4_e2m1 or fp8_e4m3 weights; ({fmt_x}, {fmt_w}, "
            f"pack_w={pack_w}) is open in {FUSED_FORMATS_ITEM}")
    if bk != BK:
        raise ValueError(f"kernel needs bk == {BK}; got bk={bk}")
    plan = fused_plan(E, M, K, N, bn=bn, split=split,
                      xb=X_CODE_BYTES[fmt_x])
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
        codes, scales = dpa_act_quant(x, fmt=fmt_x)
        err = lib.dpa_fused_tiled_launch(
            codes.data_ptr(), KERNEL_X[fmt_x], scales.data_ptr(),
            wq.data_ptr(), w_fmt, sw.data_ptr(), out.data_ptr(), E, M, K, N,
            stream)
    else:
        err = lib.dpa_grouped_fused_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), KERNEL_X[fmt_x],
            wq.data_ptr(), w_fmt, sw.data_ptr(), out.data_ptr(), E, M, K, N,
            plan.bm, plan.bn, plan.split, stream)
    build.check(err, what)
    return plan


def dpa_matmul_fused(x, wq, sw, *, fmt_x: str, fmt_w: str, bk: int = BK,
                     pack_w: bool = False, bn=None, split=None,
                     verify: bool = False):
    """(M, K) raw x times pre-quantized wq ((K//2, N) packed fp4 or
    (K, N) fp8 codes) with (1, N) column scales -> (M, N) f32.  `bn`,
    `split`: the split-K route's launch override (`fused_plan`), checked
    on any device; the plain version has no launch to take it.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_matmul_fused.launches` counts launches,
    `.<route>_launches` those of each route, `.<fmt_x>_launches` those of
    each activation format, `.verify_launches` those a speculative verify
    pass made (`verify`, set by `kernels.registry`'s `per_row`), and the
    census (`kernels.census`) their bytes, operations and bound."""
    build.forward_only("dpa_matmul_fused", x, wq, sw)
    check_fused(x, wq, sw, pack_w)
    if bn is not None or split is not None:
        fused_plan(1, x.shape[0], x.shape[1], wq.shape[1], bn=bn,
                   split=split, xb=X_CODE_BYTES.get(fmt_x, 1))
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
                        what="dpa_matmul_fused", bn=bn, split=split)
    census.count(dpa_matmul_fused, census.launch_work(
        "dpa_matmul_fused", plan.route, E=1, M=M, K=K, N=N,
        x_bytes=x.element_size(), fmt_w=fmt_w, pack_w=pack_w, fmt_x=fmt_x),
        plan.route, fmt_x, *(("verify",) if verify else ()))
    return out


census.declare(dpa_matmul_fused, "splitk", "tiled", *KERNEL_X, "verify")


# -----------------------------------------------------------------------------
# the tiled route's two stages
# -----------------------------------------------------------------------------

def dpa_act_quant_ref(x, bk: int = BK, fmt: str = "fp8_e4m3"):
    """Plain version of the tiled route's pre-pass: x (..., M, K) f32/bf16
    -> (codes (..., M, K), scales (..., M, K / bk) f32), the per-(row, K
    block) quantization of `fused_blocks` onto fmt's grid.  The codes are
    E4M3 bytes (uint8) for E4M3 and E2M1 (whose values are all E4M3
    values), fp16 values (float16) for fp16."""
    target = get_format(fmt).quant_target
    xb = x.to(torch.float32).unflatten(-1, (x.shape[-1] // bk, bk))
    scale = absmax_block_scale(xb, target, dim=-1)
    y = torch.clamp(xb / scale, -target, target)
    if fmt == "fp16":
        codes = y.to(torch.float16).flatten(-2)
    else:
        if fmt == "fp4_e2m1":
            y = decode_fp4(encode_fp4(y))
        codes = y.to(torch.float8_e4m3fn).view(torch.uint8).flatten(-2)
    return codes, scale.squeeze(-1)


def dpa_act_quant(x, bk: int = BK, fmt: str = "fp8_e4m3"):
    """Stage one of the tiled route (`csrc/dpa_fused_tiled.cu`
    `act_quant_kernel`): x (..., M, K) quantized once per (row, K block)
    onto fmt's grid (`KERNEL_X`; codes as `dpa_act_quant_ref` gives them).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_act_quant.launches` counts launches."""
    build.forward_only("dpa_act_quant", x)
    if x.device.type == "cpu":
        return dpa_act_quant_ref(x, bk, fmt)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if fmt not in KERNEL_X:
        raise NotImplementedError(
            f"dpa_act_quant kernel serves {sorted(KERNEL_X)} activations; "
            f"{fmt} is open in {FUSED_FORMATS_ITEM}")
    K = x.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16) or x.ndim < 2:
        raise TypeError(f"x must be f32/bf16 (..., M, K), got {x.dtype} "
                        f"{tuple(x.shape)}")
    if bk != BK or K % BK or K == 0:
        raise ValueError(f"kernel needs bk == {BK} and K % {BK} == 0; got "
                         f"bk={bk}, K={K}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("dpa_act_quant needs contiguous 16-byte aligned x")
    codes = torch.empty(x.shape, dtype=torch.float16 if fmt == "fp16"
                        else torch.uint8, device=x.device)
    scales = torch.empty(x.shape[:-1] + (K // BK,), dtype=torch.float32,
                         device=x.device)
    err = build.load_library().dpa_act_quant_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), KERNEL_X[fmt],
        codes.data_ptr(), scales.data_ptr(), x.numel() // K, K,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "dpa_act_quant")
    census.count(dpa_act_quant, census.launch_work(
        "dpa_act_quant", rows=x.numel() // K, K=K,
        x_bytes=x.element_size(), fmt=fmt))
    return codes, scales


census.declare(dpa_act_quant)


def dpa_fused_tiled_ref(codes, scales, wq, sw, *, fmt_w: str,
                        pack_w: bool = False, bk: int = BK):
    """Plain version of the tiled route's product: codes (..., M, K; E4M3
    bytes or fp16) and scales (..., M, K / bk) of `dpa_act_quant`, times
    wq (..., K', N)
    with column scales sw (..., 1, N), per K block a fresh partial scaled
    by its row scale and added into the running sum.  Equals
    `dpa_matmul_fused_ref` (dense) and `dpa_grouped_matmul_fused_ref`
    (an expert stack) on the raw x bit for bit."""
    wt = widen(wq, fmt_w, packed=pack_w, dim=-2).transpose(-1, -2)
    dot = rowwise_dot if codes.ndim == 2 else batched_rowwise_dot
    q = (codes.view(torch.float8_e4m3fn) if codes.dtype == torch.uint8
         else codes).to(torch.float32)
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


def prequant_plan(E: int, M: int, K: int, N: int, *, bn=None,
                  split=None) -> PrequantPlan:
    """The smallest split (a cluster size <= 8 dividing K / 128), and at
    it the widest column tile (rows x columns <= `MAX_TILE`), that bring
    the grid to `SMS` blocks; where none does, 16 columns at the largest
    split.  Raises for what the kernel cannot take exactly: K not a
    positive multiple of 128 or not below 2^16, N not a multiple of 16,
    E outside [1, 65535], M < 1.  The automatic plan is memoized: one
    lookup per call.

    `bn` and `split` (both or neither) override the launch, as the
    tuner's measured plans do, and pass the same checks or raise
    `ValueError`: bn one of `COL_TILES` dividing N with bn x row_tile <=
    `MAX_TILE`, split at most `MAX_CLUSTER` dividing K / 128.  The row
    tile is the kernel's own choice by M (`launch_rows` in
    csrc/dpa_prequant.cu picks its template instance), not a launch
    parameter, so no override reaches it."""
    if bn is None and split is None:
        return _auto_prequant_plan(E, M, K, N)
    row_tile = _check_prequant_shape(E, M, K, N)
    if bn is None or split is None:
        raise ValueError(f"a prequant override takes bn and split together;"
                         f" got bn={bn}, split={split}")
    bn, split = int(bn), int(split)
    if bn not in COL_TILES or N % bn or bn * row_tile > MAX_TILE:
        raise ValueError(f"prequant bn must be one of {COL_TILES} dividing "
                         f"N={N} with bn x {row_tile} rows <= {MAX_TILE}; "
                         f"got {bn}")
    if not 1 <= split <= MAX_CLUSTER or (K // BK) % split:
        raise ValueError(f"prequant split must be 1..{MAX_CLUSTER} dividing "
                         f"K / {BK} = {K // BK}; got {split}")
    return PrequantPlan(bn, split, row_tile,
                        E * -(-M // row_tile) * (N // bn) * split)


def _check_prequant_shape(E, M, K, N) -> int:
    """Raise for a shape the kernel cannot take; -> its row tile."""
    if K <= 0 or K % BK or K >= K_EXACT:
        raise ValueError(f"prequant kernel needs 0 < K < {K_EXACT} with K % "
                         f"{BK} == 0 (int32 sums exact in f32); got K={K}")
    if N <= 0 or N % COL_TILES[-1]:
        raise ValueError(f"prequant kernel needs N % {COL_TILES[-1]} == 0; "
                         f"got N={N}")
    if not 1 <= E <= 65535 or M < 1:
        raise ValueError(f"prequant kernel needs 1 <= E <= 65535 and M >= 1;"
                         f" got E={E}, M={M}")
    return next((t for t in ROW_TILES if M <= t), ROW_TILES[-1])


@functools.lru_cache(maxsize=None)
def _auto_prequant_plan(E: int, M: int, K: int, N: int) -> PrequantPlan:
    row_tile = _check_prequant_shape(E, M, K, N)
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


prequant_plan.cache_info = _auto_prequant_plan.cache_info
prequant_plan.cache_clear = _auto_prequant_plan.cache_clear


# the kernel's operand formats (csrc/dpa_prequant.cu), by (format, packed)
PREQUANT_FMT = build.CODE_LAYOUTS
# the pairs no exact 16-bit MMA holds (fp16 x bf16)
PREQUANT_REFUSED = {("fp16", "bf16"), ("bf16", "fp16")}


def launch_prequant(xq, wq, sx, sw, out, E, M, K, N, *, fmt_x, fmt_w,
                    pack_x, pack_w, what, bn=None, split=None):
    """Launch `csrc/dpa_prequant.cu` on CUDA operands (E = 1 dense) with
    the shape's `prequant_plan` (the override (bn, split) where given), or
    raise for what the kernel does not serve: every format the Pallas
    kernel takes, on either side, packed E2M1 or one code a byte, in any
    mix but fp16 x bf16."""
    for fmt, pack in ((fmt_x, pack_x), (fmt_w, pack_w)):
        if (fmt, pack) not in PREQUANT_FMT:
            raise ValueError(f"{what}: no {fmt} operand format "
                             f"(packed={pack}); packing needs fp4_e2m1")
    if (fmt_x, fmt_w) in PREQUANT_REFUSED:
        raise NotImplementedError(
            f"{what} kernel has no exact tensor-core product of {fmt_x} x "
            f"{fmt_w}; open in ROADMAP Queue 2 under dpa_matmul_prequant "
            "(fp16 x bf16)")
    plan = prequant_plan(E, M, K, N, bn=bn, split=split)
    for name, t, fmt in (("xq", xq, fmt_x), ("wq", wq, fmt_w)):
        if t.dtype != torch_dtype(fmt):
            raise TypeError(f"{what}: {fmt} {name} must be "
                            f"{torch_dtype(fmt)}, got {t.dtype}")
    if not all(t.is_contiguous() for t in (xq, wq, sx, sw)):
        raise ValueError(f"{what} kernel needs contiguous operands")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs 16-byte aligned codes")
    lib = build.load_library()
    err = lib.dpa_prequant_launch(
        xq.data_ptr(), PREQUANT_FMT[fmt_x, pack_x], sx.data_ptr(),
        wq.data_ptr(), PREQUANT_FMT[fmt_w, pack_w], sw.data_ptr(),
        out.data_ptr(), E, M, K, N, plan.bn, plan.split,
        torch.cuda.current_stream(xq.device).cuda_stream)
    build.check(err, what)


def dpa_matmul_prequant(xq, wq, sx, sw, *, fmt_x: str, fmt_w: str,
                        pack_x: bool = False, pack_w: bool = False,
                        bn=None, split=None):
    """(M, K') codes xq times (K', N) codes wq with (M, 1) row and (1, N)
    column f32 scales -> (M, N) f32; K' = K / 2 on a packed side.  `bn`,
    `split`: the launch override (`prequant_plan`), checked on any device.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `dpa_matmul_prequant.launches` counts launches."""
    build.forward_only("dpa_matmul_prequant", xq, wq, sx, sw)
    M, K, N = check_prequant(xq, wq, sx, sw, pack_x, pack_w)
    kw = dict(fmt_x=fmt_x, fmt_w=fmt_w, pack_x=pack_x, pack_w=pack_w)
    if bn is not None or split is not None:
        prequant_plan(1, M, K, N, bn=bn, split=split)
    if xq.device.type == "cpu":
        return dpa_matmul_prequant_ref(xq, wq, sx, sw, **kw)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    out = torch.empty((M, N), dtype=torch.float32, device=xq.device)
    launch_prequant(xq, wq, sx, sw, out, 1, M, K, N, what="dpa_matmul_prequant",
                    bn=bn, split=split, **kw)
    census.count(dpa_matmul_prequant, census.launch_work(
        "dpa_matmul_prequant", E=1, M=M, K=K, N=N, **kw))
    return out


census.declare(dpa_matmul_prequant)
