"""Block-table paged decode attention: the plain PyTorch version and the
wrapper around the CUDA kernel (`csrc/paged_decode.cu`).

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
`paged_decode_attention`: one decode step per (request, KV head) against
the paged quantized KV cache — pages read through the block table, q and
the softmax probabilities quantized per row onto the fmt grid (E4M3,
E2M1 or fp16), f32 accumulation, per-request causal mask `kpos <=
positions[b]`.

The kernel splits each (request, KV head)'s live keys across a cluster
of `paged_plan(...).split` blocks.  The speculative verify pass folds its
S_q query tokens a request into one launch (q of shape (B, S_q, H, hd)):
row (b, i) gets block-table row b and position positions[b] + i, and the
split is the decode step's at the same B (`paged_plan` of the request
batch), so every verify row carries exactly the bits of the decode step
at its position.

Formats the kernel does not serve yet raise `NotImplementedError` naming
their ROADMAP item, before the library loads (`kernel_formats`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dpa_matmul import MAX_CLUSTER, SMS
from repro_torch.models.decode_attn import (dpa_paged_decode_attn,
                                             dpa_paged_verify_attn)

_KERNEL_KV = {("fp4_e2m1", True): 0, ("fp8_e4m3", False): 1}
_KERNEL_ATTN = {"fp8_e4m3": 0, "fp4_e2m1": 1, "fp16": 2}
KERNEL_HEAD_DIMS = (64, 128)     # the kernel's head-dim template instances
MAX_G = 8                        # query heads per KV head
MIN_RANK_ROWS = 16               # no split leaves a rank fewer view rows
PLAN_BLOCKS = 3 * SMS // 2       # the grid the plan's split aims for
# dynamic shared memory a block may use: 227 KB less 1 KB for the
# kernel's static arrays
SMEM_LIMIT = 232448 - 1024
# paged_decode.cu's constants
_WARPS, _CHUNK, _STAGES = 8, 64, 4


def _a16(n: int) -> int:
    return (n + 15) & ~15


def paged_smem_bytes(G: int, hd: int, wc: int, max_pages: int, page: int,
                     split: int) -> int:
    """Dynamic shared memory of one block (`smem_layout` of
    `csrc/paged_decode.cu`): the block-table row, the logits of
    ceil(view / split) rows a head, the ring of K/V code stages (which
    the warps' PV sums reuse), and the split slots rank 0 receives."""
    cap = -(-max_pages * page // split)
    ring = max(_STAGES * _CHUNK * (wc + 4), _WARPS * G * hd * 4)
    return (_a16(max_pages * 4) + _a16(G * cap * 4) + ring
            + split * G * hd * 4 + _a16(split * G * 4))


class PagedPlan(NamedTuple):
    """The cluster size `split`, the logits rows a rank holds (`cap`), its
    shared memory in bytes and the blocks in the grid."""
    split: int
    cap: int
    smem: int
    blocks: int


@functools.lru_cache(maxsize=None)
def paged_plan(B: int, KV: int, G: int, hd: int, wc: int, page: int,
               max_pages: int) -> PagedPlan:
    """The split of each (request, KV head)'s live keys over a cluster,
    from the shapes alone: the live length is known only on the card, so
    the block table's view (max_pages * page rows) stands in for the
    longest.  Candidates are the cluster sizes 1-8 that leave each rank
    at least `MIN_RANK_ROWS` of the view and whose logits fit a block's
    shared memory; the smallest that brings the grid to `PLAN_BLOCKS`,
    else the largest.  chip_smoke.py sweeps every split at the engines'
    shape: on an H100 splits 4-7 lie within 7 % of each other, 7 the
    fastest, and 8 (256 blocks in clusters of 8 at two blocks an SM) a
    third slower (PERF.md).  Raises where none fits (a view too long for
    8 ranks).  Memoized."""
    if hd not in KERNEL_HEAD_DIMS or not 1 <= G <= MAX_G or \
            wc not in (hd // 2, hd):
        raise ValueError(f"paged decode kernel needs hd in "
                         f"{KERNEL_HEAD_DIMS}, 1 <= H/KV <= {MAX_G} and "
                         f"codes of hd or hd/2 bytes; got hd={hd}, G={G}, "
                         f"wc={wc}")
    if min(B, KV, page, max_pages) < 1 or B > 65535 or KV > 65535:
        raise ValueError(f"paged decode kernel needs 1 <= B, KV <= 65535 "
                         f"and a nonempty table; got B={B}, KV={KV}, "
                         f"page={page}, max_pages={max_pages}")
    view = page * max_pages
    fits = [s for s in range(1, MAX_CLUSTER + 1)
            if (s == 1 or view >= s * MIN_RANK_ROWS)
            and paged_smem_bytes(G, hd, wc, max_pages, page, s) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"paged decode kernel: a view of {view} rows (G={G}, hd={hd}) "
            f"does not fit {MAX_CLUSTER} ranks' shared memory")
    split = next((s for s in fits if B * KV * s >= PLAN_BLOCKS), fits[-1])
    return PagedPlan(split, -(-view // split),
                     paged_smem_bytes(G, hd, wc, max_pages, page, split),
                     B * KV * split)


def fold_plan(B: int, sq: int, KV: int, G: int, hd: int, wc: int,
              page: int, max_pages: int) -> PagedPlan:
    """The plan of a launch over B requests' sq query tokens each: the
    decode step's split at the same B (`paged_plan(B, ...)`), over a grid
    of B sq rows.  Ranks add their partial sums in rank order, so the
    split sets the bits: planning the verify fold's B sq rows as a batch
    of their own would pick a smaller split (at the engines' shapes 2
    against the decode step's 7) and verify rows would differ from decode
    rows."""
    plan = paged_plan(B, KV, G, hd, wc, page, max_pages)
    return plan._replace(blocks=plan.blocks * sq)


def paged_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                               block_table, positions, *, fmt, fmt_kv,
                               kv_packed=False, scale=None):
    """Plain version: gather the block-table view, widen, and run
    `dpa_attention` (the reference's `jnp_gather` routes: the decode step
    for one query token a request, the verify pass's batch fold for
    more)."""
    cache = {"k_codes": k_codes, "k_scale": k_scale, "v_codes": v_codes,
             "v_scale": v_scale, "block_table": block_table}
    hd = q.shape[-1]
    attn = dpa_paged_decode_attn if q.shape[1] == 1 else \
        dpa_paged_verify_attn
    return attn(q, cache, positions, fmt=fmt, fmt_kv=fmt_kv,
                kv_packed=kv_packed,
                scale=float(scale if scale is not None else hd ** -0.5))


# the ROADMAP item that lists the formats the kernel does not serve yet
FORMATS_ITEM = ("ROADMAP Queue 2 under paged_decode_attention (formats "
                "open)")


def kernel_formats(fmt, fmt_kv, kv_packed) -> tuple:
    """-> the kernel's (KV format, attention format) codes for a policy's
    (fmt_attn, fmt_kv, kv_packed); raises `NotImplementedError` naming
    the ROADMAP item for what it does not serve: f32 attention over a
    quantized cache, fp16 KV and unpacked fp4 KV.  Needs no card: the
    engine checks every policy it will run at construction."""
    kv = _KERNEL_KV.get((fmt_kv, bool(kv_packed)))
    attn = _KERNEL_ATTN.get(fmt)
    if kv is None or attn is None:
        raise NotImplementedError(
            f"paged_decode_attention kernel serves {sorted(_KERNEL_ATTN)} "
            f"attention over packed fp4_e2m1 or fp8_e4m3 KV; (fmt={fmt}, "
            f"fmt_kv={fmt_kv}, kv_packed={kv_packed}) is open in "
            f"{FORMATS_ITEM}")
    return kv, attn


def _check(q, k_codes, k_scale, v_codes, v_scale, block_table, positions):
    B, sq, H, hd = q.shape
    if sq < 1:
        raise ValueError("paged decode needs a query token a request")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32/bf16, got {q.dtype}")
    P, page, KV = k_codes.shape[:3]
    if v_codes.shape != k_codes.shape or v_codes.dtype != k_codes.dtype:
        raise ValueError("k and v code pools must match")
    for s in (k_scale, v_scale):
        if s.shape != (P, page, KV, 1) or s.dtype != torch.float32:
            raise ValueError(f"scales must be ({P}, {page}, {KV}, 1) f32")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B:
        raise ValueError("block_table must be (B, max_pages) int32")
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise ValueError("positions must be (B,) int32")
    devs = {t.device for t in (q, k_codes, k_scale, v_codes, v_scale,
                               block_table, positions)}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {devs}")


def paged_decode_attention(q, k_codes, k_scale, v_codes, v_scale,
                           block_table, positions, *, fmt, fmt_kv,
                           kv_packed=False, scale=None):
    """q (B, S_q, H, hd) rope'd queries (S_q = 1: a decode step; more: the
    verify pass, row i at positions[b] + i); k/v codes (P, page, KV, wc)
    pools with (P, page, KV, 1) f32 scales; block_table (B, max_pages)
    int32; positions (B,) int32 -> (B, S_q, H, hd) in q's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one launch for all B S_q rows) or raises.  Counters:
    `paged_decode_attention.launches` every launch, `.<fmt>_launches` by
    attention format, `.verify_launches` the verify folds (S_q > 1)."""
    build.forward_only("paged_decode_attention", q, k_codes, k_scale,
                       v_codes, v_scale)
    _check(q, k_codes, k_scale, v_codes, v_scale, block_table, positions)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_codes, k_scale, v_codes, v_scale, block_table, positions,
            fmt=fmt, fmt_kv=fmt_kv, kv_packed=kv_packed, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    out = launch_paged(q, k_codes, k_scale, v_codes, v_scale, block_table,
                       positions, fmt=fmt, fmt_kv=fmt_kv, kv_packed=kv_packed,
                       scale=scale)
    fn = paged_decode_attention
    fn.launches += 1
    setattr(fn, f"{fmt}_launches", getattr(fn, f"{fmt}_launches") + 1)
    if q.shape[1] > 1:
        fn.verify_launches += 1
    return out


def launch_paged(q, k_codes, k_scale, v_codes, v_scale, block_table,
                 positions, *, fmt, fmt_kv, kv_packed=False, scale=None):
    """The kernel launch behind `paged_decode_attention`: the formats, the
    shapes and the alignment are checked before the library loads."""
    kv_fmt, attn_fmt = kernel_formats(fmt, fmt_kv, kv_packed)
    B, sq, H, hd = q.shape
    KV = k_codes.shape[2]
    if B * sq > 65535:
        raise ValueError(f"kernel needs B * S_q <= 65535; got {B} x {sq}")
    if hd not in KERNEL_HEAD_DIMS or H % KV or H // KV > MAX_G:
        raise ValueError(f"kernel needs hd in {KERNEL_HEAD_DIMS} and H/KV <= "
                         f"{MAX_G}; got hd={hd}, H={H}, KV={KV}")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, block_table, positions)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "operands")
    if any(t.data_ptr() % 16 for t in (q, k_codes, v_codes)):
        raise ValueError("paged_decode_attention kernel needs 16-byte "
                         "aligned q and code pools")
    plan = fold_plan(B, sq, KV, H // KV, hd, k_codes.shape[3],
                     k_codes.shape[1], block_table.shape[1])
    out = torch.empty_like(q)
    lib = build.load_library()
    err = lib.paged_decode_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
        k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(), B,
        sq, H, KV, hd, k_codes.shape[1], block_table.shape[1], kv_fmt,
        attn_fmt, float(scale if scale is not None else hd ** -0.5),
        plan.split, torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    return out


paged_decode_attention.launches = 0
for _fmt in _KERNEL_ATTN:
    setattr(paged_decode_attention, f"{_fmt}_launches", 0)
paged_decode_attention.verify_launches = 0
