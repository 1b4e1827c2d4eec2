"""Row quantizers: the plain PyTorch versions, the launch plan and the
wrappers around the CUDA kernel (`csrc/quantize_rows.cu`).

`quantize_rows` replaces the Pallas TPU kernel `repro/kernels/quantize.py`
`quantize_rows`: per-row absmax scale, `clip(x / scale, +-target)` and a
saturating cast onto the format's grid, in every format of the format
table: native E4M3 / E5M2 / fp16 / bf16 / f32 codes, or one uint8 E2M1
code per element.  `quantize_pack_rows` replaces `quantize_pack_rows` of
the same file: the E2M1 codes packed two per byte along K, low nibble =
even index.  Codes and scales of kernel and plain version are
bit-identical.

The kernel reads x once: `quantize_plan` gives each row a group of
threads that hold its 16-byte chunks (or pairs of elements, where K or
the base is not 16-byte aligned) in registers from the absmax to the
cast; only rows too long for that take a second read.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.formats import FloatFormat, get_format, torch_dtype
from repro_torch.core.packing import pack_fp4
from repro_torch.core.quantize import cast_to, compute_scale, encode_fp4
from repro_torch.kernels import build, census

# the kernel's format codes (2 is packed E2M1): every format of the table
_KERNEL_FMT = {"fp8_e4m3": 0, "fp4_e2m1": 1, "fp16": 3, "bf16": 4,
               "fp8_e5m2": 5, "fp32": 6}
_PACKED_FP4 = 2
_X_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# csrc/quantize_rows.cu's constants
MAX_VECS = 4                 # chunks a thread holds (kMaxVecs)
MAX_THREADS = 1024
VECTOR_BYTES = 16            # a chunk on the vector route
GROUP_THREADS = 128          # a block's threads where rows share warps


class QuantizePlan(NamedTuple):
    """The kernel's launch: `route` "vector" (16-byte chunks) or "scalar"
    (pairs of elements loaded one at a time), with "_reread" where a row
    does not fit `lanes` x `nv` chunks and is read twice; `width` elements
    a chunk, `lanes` threads a row, `rows` rows a block, `nv` chunks a
    thread holds, `tiles` the passes over a row (1: x read once) and the
    blocks in the grid."""
    route: str
    width: int
    lanes: int
    rows: int
    nv: int
    tiles: int
    blocks: int


@functools.lru_cache(maxsize=None)
def quantize_plan(M: int, K: int, x_dtype: torch.dtype, fmt: str, *,
                  pack: bool = False, aligned: bool = True) -> QuantizePlan:
    """The launch by shape: the vector route where K x element bytes is a
    multiple of 16 and the base is 16-byte `aligned`, else the scalar
    route (chunks of two elements).  Each thread aims at `MAX_VECS`
    chunks (64 bytes of x in flight on the vector route; the fastest
    split in `tools/quantize_rows_ablation.py`'s sweep, PERF.md).  A row of at most `32 * MAX_VECS` chunks takes a
    power-of-two group of lanes (several rows a warp, the absmax by a
    segmented shuffle); a longer one whole warps, one row a block, up to
    1024 threads; past that the row is walked in tiles (the "_reread"
    routes).  Raises for what the kernel does not take.  Memoized."""
    if x_dtype not in _X_BYTES:
        raise TypeError(f"quantize kernel takes f32/bf16 x, got {x_dtype}")
    if fmt not in _KERNEL_FMT or (pack and fmt != "fp4_e2m1"):
        raise ValueError(f"quantize kernel has no {fmt} (pack={pack})")
    if M < 1 or K < 1 or (pack and K % 2):
        raise ValueError(f"quantize kernel needs M, K >= 1 (K even to "
                         f"pack); got M={M}, K={K}")
    vector = aligned and K * _X_BYTES[x_dtype] % VECTOR_BYTES == 0
    width = VECTOR_BYTES // _X_BYTES[x_dtype] if vector else 2
    chunks = -(-K // width)
    if chunks <= 32 * MAX_VECS:
        lanes = 1 << (-(-chunks // MAX_VECS) - 1).bit_length()
        rows = GROUP_THREADS // lanes
    else:
        lanes = 32 * min(MAX_THREADS // 32, -(-chunks // (32 * MAX_VECS)))
        rows = 1
    nv = min(MAX_VECS, -(-chunks // lanes))
    tiles = -(-chunks // (lanes * nv))
    route = ("vector" if vector else "scalar") + ("_reread" if tiles > 1
                                                  else "")
    return QuantizePlan(route, width, lanes, rows, nv, tiles, -(-M // rows))


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


def _launch(x, codes, fmt: str, pack: bool, what: str):
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype not in _X_BYTES:
        raise TypeError(f"{what} kernel takes f32/bf16 x, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous x")
    M, K = x.shape
    plan = quantize_plan(M, K, x.dtype, fmt, pack=pack,
                         aligned=x.data_ptr() % VECTOR_BYTES == 0)
    scales = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    err = build.load_library().quantize_rows_launch(
        x.data_ptr(), int(x.dtype == torch.bfloat16), codes.data_ptr(),
        scales.data_ptr(), M, K, _PACKED_FP4 if pack else _KERNEL_FMT[fmt],
        int(plan.route.startswith("vector")), plan.lanes, plan.rows,
        plan.nv, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, what)
    return codes, scales


def quantize_rows(x, *, fmt: str):
    """(M, K) f32/bf16 -> (codes (M, K) in fmt's dtype, or uint8 E2M1
    codes, scales (M, 1) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `quantize_rows.launches` counts launches."""
    build.forward_only("quantize_rows", x)
    _check(x, False)
    if x.device.type == "cpu":
        return quantize_rows_ref(x, fmt=fmt)
    name = fmt.name if isinstance(fmt, FloatFormat) else fmt
    if name not in _KERNEL_FMT:
        raise NotImplementedError(
            f"quantize_rows kernel serves every format of the format "
            f"table, {sorted(_KERNEL_FMT)}; {fmt!r} is not one")
    codes = torch.empty(x.shape, dtype=torch_dtype(name), device=x.device)
    out = _launch(x, codes, name, False, "quantize_rows")
    census.count(quantize_rows, census.launch_work(
        "quantize_rows", M=x.shape[0], K=x.shape[1],
        x_bytes=x.element_size(), fmt=name))
    return out


census.declare(quantize_rows)


def quantize_pack_rows(x):
    """(M, K) f32/bf16 -> (packed E2M1 codes (M, K / 2) uint8, scales (M,
    1) f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `quantize_pack_rows.launches` counts launches."""
    build.forward_only("quantize_pack_rows", x)
    _check(x, True)
    if x.device.type == "cpu":
        return quantize_pack_rows_ref(x)
    M, K = x.shape
    codes = torch.empty((M, K // 2), dtype=torch.uint8, device=x.device)
    out = _launch(x, codes, "fp4_e2m1", True, "quantize_pack_rows")
    census.count(quantize_pack_rows, census.launch_work(
        "quantize_pack_rows", M=M, K=K, x_bytes=x.element_size()))
    return out


census.declare(quantize_pack_rows)
