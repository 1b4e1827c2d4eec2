"""The work of each kernel launch: the bytes it moves, the operations it
does and the least time the card could take for them (its bound).

The card's constants are the data-sheet figures of the H100 SXM5 80GB:
HBM3 at 3.35 TB/s and the dense tensor-core peaks, 1979 Top/s for fp8
and 989 for fp16 / bf16, with f32 outside the tensor cores at 67.
`PEAK_OPS` gives each operand format its peak.  E2M1 takes fp8's: Hopper
has no fp4 tensor-core rate, and the port's E2M1 x E2M1 products run on
int8 `mma.sync` at that rate.  f32 is the CUDA-core rate: the f32 routes'
pin (2e-6) rules out TF32.  The paper's DPA term-count scale
(`hwmodel.throughput.peak_flops_scale`) would give fp4 four times the
bf16 peak, a rate the card does not have, so no peak here uses it.

`launch_work(kernel, route, **shapes)` counts one launch of a kernel
wrapper as the function the wrapper computes: its inputs read once, its
output written once, the products over the live elements only.  A
kernel behind a pre-pass (the fused matmul's tiled route, the DPA flash
kernel on raw K/V, the f32 flash kernel on f32 K/V) is counted on its
raw inputs, as the function it completes; the pre-pass is counted as its
own launch as well (`dpa_act_quant`, the row quantizers, the f32 flash
kernel's K/V split).  Paged decode reads each request's keys up to its
position, which only the device holds: the wrappers count the block
table's reach, an upper bound, and a caller that knows the lengths
passes the live keys.

`bound_s(bytes, ops, peak)` = max(bytes / HBM, ops / peak).  A layer's
or a path's bound is the sum of its launches' bounds, not the bound of
their summed bytes and operations: a launch that waits on memory does
not lend its idle tensor cores to the next one.

`pool_gather_work` counts the sharded paged routes' one collective, the
pool all-gather of tensor-parallel serving (`distributed.tp`): the bytes
a rank receives over the interconnect, bounded by the card's NVLink rate
(`wire_bound_s`), the counterpart of the reference roofline's collective
term.

`declare` and `count` keep the wrappers' counters (`kernels.counters`):
each launch adds one to `.launches` and its work to `.bytes`, `.ops`
and `.bound_s`, and the same to `.<route>_launches`, `.<route>_bytes`,
... of each route it is counted under.  Pure Python on shapes: no
tensor operation and no sync, so a launch stays capturable in a CUDA
graph (`launch.graphs.StepGraph` adds a capture's counters once per
replay).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12         # H100 SXM5 80GB HBM3 (data sheet)
FP8_OPS_PER_S = 1979e12           # H100 SXM5 dense fp8 tensor-core peak
FP16_OPS_PER_S = 989e12           # H100 SXM5 dense fp16 / bf16 peak
F32_OPS_PER_S = 67e12             # H100 SXM5 f32 outside the tensor cores
LINK_BYTES_PER_S = 450e9          # H100 SXM5 NVLink 4, one direction (of
                                  # the data sheet's 900 GB/s both ways)
PEAK_OPS = {"fp8_e4m3": FP8_OPS_PER_S, "fp8_e5m2": FP8_OPS_PER_S,
            "fp4_e2m1": FP8_OPS_PER_S, "fp16": FP16_OPS_PER_S,
            "bf16": FP16_OPS_PER_S, "fp32": F32_OPS_PER_S}
# bytes of one code a byte-aligned element takes, by format
CODE_BYTES = {"fp8_e4m3": 1, "fp8_e5m2": 1, "fp4_e2m1": 1, "fp16": 2,
              "bf16": 2, "fp32": 4}
BK = 128                          # the fused matmul's activation K block
WORK = ("bytes", "ops", "bound_s")


class Work(NamedTuple):
    """One launch's bytes moved, operations done and the peak they run
    at (op/s)."""
    bytes: int
    ops: int
    peak: float


def bound_s(nbytes: float, ops: float, peak: float) -> float:
    """The least time for the work: max(bytes / HBM, ops / peak), s."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def bound_by(nbytes: float, ops: float, peak: float) -> str:
    """Which term `bound_s` takes: "bytes" or "operations"."""
    return ("bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak
            else "operations")


def operand_bytes(n: int, fmt: str, packed: bool = False) -> int:
    """Bytes of n codes in fmt (E2M1 two a byte when packed)."""
    return n // 2 if packed else n * CODE_BYTES[fmt]


@functools.lru_cache(maxsize=None)
def attn_pairs(sq: int, sk: int, causal: bool = True, window=None) -> int:
    """Live (q, k) pairs of one head: query i sits at key position
    i + sk - sq; causal keeps keys at or before it, a window the last
    `window` of those."""
    total = 0
    for i in range(sq):
        qpos = i + sk - sq
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window else 0
        total += max(0, hi - lo + 1)
    return total


def _fused(E, M, K, N, x_bytes, fmt_w, pack_w, fmt_x="fp8_e4m3"):
    """Raw (E, M, K) x, (E, K, N) weight codes and (E, 1, N) f32 column
    scales in, (E, M, N) f32 out; 2 E M K N at the narrower operand
    format's peak (E4M3 and E2M1 activations at fp8's, fp16 at 989)."""
    nbytes = (E * M * K * x_bytes + E * operand_bytes(K * N, fmt_w, pack_w)
              + E * N * 4 + E * M * N * 4)
    return Work(nbytes, 2 * E * M * K * N,
                min(PEAK_OPS[fmt_x], PEAK_OPS[fmt_w]))


def _act_quant(rows, K, x_bytes, fmt="fp8_e4m3"):
    """Raw (rows, K) in; codes (one byte a value, E2M1 as E4M3 bytes;
    two at fp16) and one f32 scale a K block out."""
    return Work(rows * K * (x_bytes + CODE_BYTES[fmt])
                + rows * (K // BK) * 4, 0, PEAK_OPS[fmt])


def _prequant(E, M, K, N, fmt_x, fmt_w, pack_x, pack_w):
    """(E, M, K) and (E, K, N) codes, (E, M, 1) and (E, 1, N) f32 scales
    in, (E, M, N) f32 out; 2 E M K N at the narrower side's peak."""
    nbytes = (E * operand_bytes(M * K, fmt_x, pack_x) + E * M * 4
              + E * operand_bytes(K * N, fmt_w, pack_w) + E * N * 4
              + E * M * N * 4)
    return Work(nbytes, 2 * E * M * K * N,
                min(PEAK_OPS[fmt_x], PEAK_OPS[fmt_w]))


def _paged(fmt, B, sq, H, KV, hd, code_bytes, q_bytes, table_entries,
           kv_rows, pairs):
    """kv_rows keys of each KV head read once, K and V (codes and one f32
    scale a row); q read and the output written; the block table and
    positions.  QK and PV over `pairs` (query row, key) pairs a head at
    the attention format's peak."""
    nbytes = (2 * kv_rows * KV * (code_bytes + 4) + 2 * B * sq * H * hd
              * q_bytes + table_entries * 4 + B * 4)
    return Work(nbytes, 4 * pairs * H * hd, PEAK_OPS[fmt])


def _dpa_flash(B, H, KV, sq, sk, hd, q_bytes, kv_row_bytes, causal, window,
               fmt="fp8_e4m3"):
    """q read and the output written in q's dtype, K and V rows as the
    wrapper takes them (raw, or codes and a scale); QK and PV over the
    live pairs at the attention format's peak (fp8's for E4M3 and E2M1,
    989 for fp16)."""
    nbytes = 2 * B * H * sq * hd * q_bytes + 2 * B * KV * sk * kv_row_bytes
    return Work(nbytes, 4 * B * H * hd * attn_pairs(sq, sk, causal, window),
                PEAK_OPS[fmt])


def _flash(B, H, KV, sq, sk, hd, elem, causal, window):
    """q, K, V read and the output written in their dtype; QK and PV over
    the live pairs as split-bf16 tensor-core products: three a product
    for bf16 inputs, six for f32 (the pieces of weight 2^-16 and more),
    at the bf16 peak."""
    pieces = 3 if elem == 2 else 6
    nbytes = elem * hd * (2 * B * H * sq + 2 * B * KV * sk)
    return Work(nbytes, pieces * 4 * B * H * hd
                * attn_pairs(sq, sk, causal, window), PEAK_OPS["bf16"])


def _kv_split(rows, hd):
    """The f32 flash kernel's pre-pass on K or V: f32 rows in, three bf16
    pieces out."""
    return Work(rows * hd * (4 + 3 * 2), 0, PEAK_OPS["bf16"])


def _quantize(M, K, x_bytes, fmt):
    """Raw (M, K) in; (M, K) codes and (M, 1) f32 scales out."""
    return Work(M * K * (x_bytes + CODE_BYTES[fmt]) + M * 4, 0,
                PEAK_OPS[fmt])


def _quantize_pack(M, K, x_bytes):
    """Raw (M, K) in; (M, K / 2) packed E2M1 codes and (M, 1) scales
    out."""
    return Work(M * K * x_bytes + M * K // 2 + M * 4, 0,
                PEAK_OPS["fp4_e2m1"])


def pool_gather_work(n_ranks: int, pool_rows: int, hd: int, fmt: str,
                     packed: bool = False) -> int:
    """Bytes one rank receives in one layer's pool all-gather (the
    sharded `paged_decode` / `verify_attn` routes): the other (n-1)/n of
    the pool's K and V rows, codes and one f32 scale a row; 0 on one
    rank."""
    if n_ranks <= 1:
        return 0
    row = (hd // 2 if packed else hd * CODE_BYTES[fmt]) + 4
    return int((n_ranks - 1) / n_ranks * 2 * pool_rows * row)


def wire_bound_s(nbytes: float) -> float:
    """The least time for `nbytes` received over NVLink, s."""
    return nbytes / LINK_BYTES_PER_S


# wrapper -> {route: counting function}; None is the wrapper's own launch
_KERNELS = {
    "dpa_matmul_fused": {"splitk": _fused, "tiled": _fused},
    "dpa_grouped_matmul_fused": {"splitk": _fused, "tiled": _fused},
    "dpa_act_quant": {None: _act_quant},
    "dpa_matmul_prequant": {None: _prequant},
    "dpa_grouped_matmul_prequant": {None: _prequant},
    "paged_decode_attention": {None: _paged},
    "dpa_flash_attention": {None: _dpa_flash},
    "flash_attention": {None: _flash, "prepass": _kv_split},
    "quantize_rows": {None: _quantize},
    "quantize_pack_rows": {None: _quantize_pack},
}


@functools.lru_cache(maxsize=4096)
def _work(kernel, route, shapes):
    return _KERNELS[kernel][route](**dict(shapes))


def launch_work(kernel: str, route=None, **shapes) -> Work:
    """-> (bytes, operations, peak) of one launch of `kernel` (a wrapper's
    name, `counters.WRAPPERS`) on `route` at `shapes` (the keyword
    arguments of its counting function above).  Memoized."""
    return _work(kernel, route, tuple(sorted(shapes.items())))


def declare(fn, *routes) -> None:
    """Zero fn's counters: launches and work, its own and each route's."""
    for prefix in ("",) + tuple(f"{r}_" for r in routes):
        setattr(fn, prefix + "launches", 0)
        for w in WORK:
            setattr(fn, prefix + w, 0)


def count(fn, work: Work, *routes, own: bool = True) -> None:
    """One launch of `work`: counted on fn itself (unless `own` is off:
    a pre-pass the wrapper's launches do not include) and on each
    route."""
    b_s = bound_s(*work)
    for prefix in (("",) if own else ()) + tuple(f"{r}_" for r in routes):
        setattr(fn, prefix + "launches", getattr(fn, prefix + "launches")
                + 1)
        setattr(fn, prefix + "bytes", getattr(fn, prefix + "bytes")
                + work.bytes)
        setattr(fn, prefix + "ops", getattr(fn, prefix + "ops") + work.ops)
        setattr(fn, prefix + "bound_s", getattr(fn, prefix + "bound_s")
                + b_s)
