"""Quantized KV-cache layer: format-width storage for decode attention
(port of `repro.core.kvcache`).

Contiguous layout, one entry per (batch, position, kv-head) row:

  k_codes / v_codes : (B, S, KV, hd) narrow dtype (fp16/bf16/fp8), or
                      uint8 E2M1 codes for fp4 — (B, S, KV, hd // 2)
                      packed bytes when `packed` (low nibble = even index).
  k_scale / v_scale : (B, S, KV, 1) f32 per-row absmax scales.

Paged layout — the serving engine's: a pool of fixed-size pages shared
by every live request, and a (B, max_pages) int32 block table; token t of
request b lives at (table[b, t // page], t % page).  Page 0 is the
scratch page idle decode slots point at.

Both layouts share one recipe — `quant_rows_grid` over head_dim — so a
paged cache holds codes/scales bit-identical to the contiguous cache it
replaces (paging is pure relayout).

Unlike the reference's functional updates, the writers here update the
pools in place (the full-width pools are hundreds of MB; copying them per
token would double the traffic) and return the same dict.
"""
from __future__ import annotations

import numpy as np
import torch

from .formats import get_format, torch_dtype
from .packing import operand_nbytes, pack_fp4, unpack_fp4
from .quantize import decode_fp4, encode_fp4, quant_rows_grid

QUANT_KEYS = ("k_codes", "k_scale", "v_codes", "v_scale")


def _codes_width(hd: int, fmt, packed: bool) -> int:
    fmt = get_format(fmt)
    if fmt.name == "fp4_e2m1" and packed:
        if hd % 2:
            raise ValueError(f"packed fp4 KV needs an even head_dim, got {hd}")
        return hd // 2
    return hd


def quantize_kv(x, *, fmt, packed: bool = False):
    """(..., hd) raw K or V -> (codes, scale) in the cache layout."""
    fmt = get_format(fmt)
    grid, scale = quant_rows_grid(x, fmt)
    if fmt.name == "fp4_e2m1":
        codes = encode_fp4(grid)
        if packed:
            codes = pack_fp4(codes)
    else:
        codes = grid.to(torch_dtype(fmt))
    return codes, scale


def dequantize_kv(codes, scale, *, fmt, packed: bool = False):
    """Cache rows -> f32 values: widen(codes) * scale."""
    fmt = get_format(fmt)
    if fmt.name == "fp4_e2m1":
        grid = decode_fp4(unpack_fp4(codes) if packed else codes)
    else:
        grid = codes.to(torch.float32)
    return grid * scale


def init_kv_cache(batch: int, s_ctx: int, n_kv: int, hd: int, *, fmt,
                  packed: bool = False, device="cpu"):
    """Zeroed quantized contiguous cache."""
    wc = _codes_width(hd, fmt, packed)
    def zeros(width, dtype):
        return torch.zeros((batch, s_ctx, n_kv, width), dtype=dtype,
                           device=device)

    return {"k_codes": zeros(wc, torch_dtype(fmt)),
            "k_scale": zeros(1, torch.float32),
            "v_codes": zeros(wc, torch_dtype(fmt)),
            "v_scale": zeros(1, torch.float32)}


def _update_offset(offset, s_ctx: int, s_new: int):
    """The reference's dynamic_update_slice start: a negative start counts
    from the end (start + s_ctx, as jax's does), then the start is clamped
    so the update fits inside the cache.  A 0-dim integer tensor (a
    captured step's offset, read at every replay) stays a tensor."""
    if torch.is_tensor(offset):
        offset = torch.where(offset < 0, offset + s_ctx, offset)
        return offset.clamp(0, s_ctx - s_new)
    offset = int(offset)
    if offset < 0:
        offset += s_ctx
    return min(max(offset, 0), s_ctx - s_new)


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def write_rows(dst, new, offset):
    """dst[:, start:start + S_new] = new along axis 1 (in place), start =
    `_update_offset(offset)`.  A tensor start writes with `index_copy_` at
    start + arange(S_new), on the rows' bit patterns (the same bytes as
    the slice write, whatever the narrow dtype)."""
    start = _update_offset(offset, dst.shape[1], new.shape[1])
    if not torch.is_tensor(start):
        dst[:, start:start + new.shape[1]] = new
        return dst
    idx = start.to(torch.int64) + torch.arange(new.shape[1],
                                               device=dst.device)
    bits = _BITS[dst.element_size()]
    dst.view(bits).index_copy_(1, idx, new.to(dst.dtype).view(bits))
    return dst


def update_kv_cache(cache, k_new, v_new, offset, *, fmt,
                    packed: bool = False):
    """Quantize k/v (B, S_new, KV, hd) and write them at `offset` (an int
    or a 0-dim integer tensor) along the sequence axis (in place)."""
    kc, ks = quantize_kv(k_new, fmt=fmt, packed=packed)
    vc, vs = quantize_kv(v_new, fmt=fmt, packed=packed)
    for key, new in (("k_codes", kc), ("k_scale", ks),
                     ("v_codes", vc), ("v_scale", vs)):
        write_rows(cache[key], new, offset)
    return cache


def dequantize_cache(cache, *, fmt, packed: bool = False):
    """-> (k, v) f32 (B, S, KV, hd)."""
    k = dequantize_kv(cache["k_codes"], cache["k_scale"], fmt=fmt,
                      packed=packed)
    v = dequantize_kv(cache["v_codes"], cache["v_scale"], fmt=fmt,
                      packed=packed)
    return k, v


def kv_cache_nbytes(batch: int, s_ctx: int, n_kv: int, hd: int, *, fmt,
                    packed: bool = False) -> dict:
    """Bytes one layer's K+V cache moves per full sweep (codes + f32
    scales) vs the f32 cache."""
    n_rows = batch * s_ctx * n_kv
    code_b = operand_nbytes(n_rows * hd, fmt, packed=packed)
    total = 2 * (code_b + 4 * n_rows)
    f32 = 2 * 4 * n_rows * hd
    return {"total": total, "f32_total": f32,
            "reduction_vs_f32": f32 / total}


# -----------------------------------------------------------------------------
# paged layout: page pool + block table
# -----------------------------------------------------------------------------

SCRATCH_PAGE = 0


def init_paged_kv_cache(n_pages: int, page_size: int, n_kv: int, hd: int,
                        *, fmt, packed: bool = False, device="cpu"):
    """Zeroed page pool: {k,v}_codes (P, page, KV, wc) + f32 scales."""
    return init_kv_cache(n_pages, page_size, n_kv, hd, fmt=fmt,
                         packed=packed, device=device)


def make_block_table(n_slots: int, max_pages: int, device="cpu"):
    """All-scratch (B, max_pages) int32 table."""
    return torch.full((n_slots, max_pages), SCRATCH_PAGE, dtype=torch.int32,
                      device=device)


def _shard_rows(ps_local: int, shard) -> tuple:
    """(first row, page size) of the rank's slice of every page: a pool
    sharded over n ranks holds rows [r * page / n, (r + 1) * page / n)
    of each page on rank r (`distributed.sharding.cache_placement`)."""
    rank, n = shard
    if not 0 <= rank < n:
        raise ValueError(f"shard {shard}: rank outside the group")
    return rank * ps_local, ps_local * n


def paged_write_tokens(cache, k_new, v_new, positions, *, fmt,
                       packed: bool = False, shard=(0, 1)):
    """Quantize S_new tokens per batch slot into its pages (in place).

    k_new/v_new: (B, S_new, KV, hd); positions: (B,) int32 timeline index
    of each slot's first new token; token i of row b lands at
    (table[b, p // page], p % page) with p = positions[b] + i.  Idle
    slots carry an all-scratch table row, so their writes hit the scratch
    page.  `shard` (rank, ranks): the pool holds only the rank's rows of
    every page (`_shard_rows`); a token whose row lies on another rank
    is written to the scratch page's first row instead, which no live
    request reads (no host sync, no conflicting writes)."""
    ps_local = cache["k_codes"].shape[1]
    lo, ps = _shard_rows(ps_local, shard)
    table = cache["block_table"]
    s_new = k_new.shape[1]
    pos = positions.to(torch.int64)[:, None] + torch.arange(
        s_new, device=k_new.device)[None]
    page = torch.gather(table.to(torch.int64), 1, pos // ps)
    slot = pos % ps - lo
    if ps_local != ps:
        mine = (slot >= 0) & (slot < ps_local)
        page = torch.where(mine, page, SCRATCH_PAGE)
        slot = torch.where(mine, slot, 0)
    kc, ks = quantize_kv(k_new, fmt=fmt, packed=packed)
    vc, vs = quantize_kv(v_new, fmt=fmt, packed=packed)
    for key, new in (("k_codes", kc), ("k_scale", ks),
                     ("v_codes", vc), ("v_scale", vs)):
        cache[key][page, slot] = new
    return cache


def gather_paged_kv(cache):
    """Page pool + block table -> contiguous-layout view (B, max_pages *
    page, KV, ...), request b's timeline in order (pure relayout)."""
    table = cache["block_table"].to(torch.int64)
    B, n_pg = table.shape
    out = {}
    for key in QUANT_KEYS:
        pool = cache[key]
        g = pool[table]                          # (B, n_pg, page, KV, w)
        out[key] = g.reshape((B, n_pg * pool.shape[1]) + pool.shape[2:])
    return out


def write_prefill_rows(cache, rows, page_ids, length: int, *,
                       start: int = 0, shard=(0, 1)):
    """Scatter a prefill's rows [`start`, `length`) into pages (in place).

    rows: contiguous-layout dict with leaves (S, KV, ...) for one request;
    page_ids: the request's pages in timeline order; rows before `start`
    (a shared prefix) are not rewritten.  `shard` (rank, ranks): the pool
    holds only the rank's rows of every page, and only those are written,
    at their offset within the rank's slice."""
    ps_local = cache["k_codes"].shape[1]
    first, ps = _shard_rows(ps_local, shard)
    n_need = -(-length // ps) if length else 0
    if n_need > len(page_ids):
        raise ValueError(f"{length} rows need {n_need} pages, "
                         f"got {len(page_ids)}")
    if not 0 <= start <= length:
        raise ValueError(f"start ({start}) outside [0, {length}]")
    for key in QUANT_KEYS:
        pool, src = cache[key], rows[key]
        for j in range(n_need):
            # the page's global rows [lo, n), cut to the rank's slice
            lo = max(start - j * ps, first)
            n = min(length - j * ps, first + ps_local)
            if lo >= n:
                continue
            pid = int(page_ids[j])
            pool[pid, lo - first:n - first] = src[j * ps + lo:j * ps + n]
    return cache


def gather_page_rows(cache, page_ids, length: int) -> dict:
    """The first `length` timeline rows stored in `page_ids` (in order) as
    contiguous (length, KV, ...) leaves, bit for bit: the inverse of
    `write_prefill_rows`.  The gather runs on the leaves' bit patterns,
    so any narrow dtype moves unchanged."""
    ps = cache["k_codes"].shape[1]
    n_need = -(-length // ps)
    if n_need > len(page_ids):
        raise ValueError(f"{length} rows need {n_need} pages, "
                         f"got {len(page_ids)}")
    return {key: pages.reshape((-1,) + pages.shape[2:])[:length]
            for key, pages in select_pages(cache, page_ids[:n_need]).items()}


def select_pages(cache, page_ids) -> dict:
    """The pool leaves' pages `page_ids`, in order, as (n, page, KV, ...)
    copies, bit for bit (selected on the leaves' bit patterns, so any
    narrow dtype moves unchanged)."""
    dev = cache["k_codes"].device
    ids = torch.tensor([int(p) for p in page_ids], dtype=torch.int64,
                       device=dev)
    out = {}
    for key in QUANT_KEYS:
        pool = cache[key]
        bits = pool.view(_BITS[pool.element_size()])
        out[key] = bits.index_select(0, ids).view(pool.dtype)
    return out


def paged_from_contiguous(ref, lengths, *, page_size: int,
                          n_pages: int = None):
    """Relayout a contiguous quantized cache into a fresh paged one (pure
    relayout; the standard paged-vs-contiguous fixture)."""
    B = ref["k_codes"].shape[0]
    dev = ref["k_codes"].device
    n_need = [max(1, -(-int(n) // page_size)) for n in lengths]
    if n_pages is None:
        n_pages = sum(n_need) + 2
    alloc = PageAllocator(n_pages)
    table = np.full((B, max(n_need, default=1)), SCRATCH_PAGE, np.int32)
    cache = {key: torch.zeros((n_pages, page_size) + tuple(ref[key].shape[2:]),
                              dtype=ref[key].dtype, device=dev)
             for key in QUANT_KEYS}
    for b, n in enumerate(lengths):
        ids = alloc.alloc(n_need[b])
        table[b, :len(ids)] = ids
        rows = {key: ref[key][b] for key in QUANT_KEYS}
        write_prefill_rows(cache, rows, ids, int(n))
    cache["block_table"] = torch.from_numpy(table).to(dev)
    return cache


def paged_kv_cache_nbytes(live_tokens: int, pages_in_use: int,
                          page_size: int, n_kv: int, hd: int, *, fmt,
                          packed: bool = False) -> dict:
    """`live`: rows live requests occupy; `paged`: whole pages in use."""
    def row_bytes(n_rows):
        return 2 * (operand_nbytes(n_rows * hd, fmt, packed=packed)
                    + 4 * n_rows)
    return {"live": row_bytes(live_tokens * n_kv),
            "paged": row_bytes(pages_in_use * page_size * n_kv)}


class PageAllocator:
    """Free-list page allocator for the paged KV cache.

    Page 0 is reserved as the scratch page idle decode slots write to, so
    `capacity` pages yield `capacity - 1` allocatable ones.  Freed pages
    return to the free list and are reused LIFO (hot pages stay cache-
    warm).  Tracks in-use count and the peak for utilization reporting.

    Reservations (the speculative-decoding commit/rollback protocol):
    a request may `reserve(n)` pages without popping them — reserved
    pages stay on the free list but are excluded from `can_alloc`, so no
    other request can claim them (the engine's no-OOM-mid-decode
    invariant survives lazy committing).  `alloc(n, reserved=True)`
    *commits* pages out of the caller's reservation as its timeline
    grows; `free(pages, to_reserved=True)` rolls committed pages back
    into the reservation (the KV-rollback path: pages holding only
    rejected draft tokens return without becoming grabbable by anyone
    else); `unreserve(n)` releases the unused remainder at finish.
    Invariant: ``reserved <= n_free`` always — every reserved page is
    physically on the free list until committed.

    Reference counts (the prefix-sharing protocol): `alloc` hands a page
    out with refcount 1; `incref` adds holders (a prefix-cache entry, a
    request matching a cached prefix).  `free` is a *decref* — the page
    only returns to the free list when its last holder releases it, so a
    shared page can never be freed or re-handed-out while any request's
    block table still points at it.  Shared pages (refcount > 1) are
    read-only by convention: a diverging request must copy-on-write into
    a private page (the engine's `_cow_copy`).  Rollback
    (`to_reserved=True`) refuses shared pages outright — only a page the
    caller exclusively owns can fold back into its reservation."""

    def __init__(self, capacity: int):
        if capacity < 2:
            raise ValueError("need >= 2 pages (page 0 is scratch)")
        self.capacity = capacity
        self._free = list(range(capacity - 1, 0, -1))   # pop() -> page 1 first
        self._used = set()
        self._refs = {}                                 # page -> holder count
        self.reserved = 0
        self.peak_in_use = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    @property
    def n_available(self) -> int:
        """Free pages not spoken for by a reservation."""
        return self.n_free - self.reserved

    def can_alloc(self, n: int) -> bool:
        return n <= self.n_available

    def reserve(self, n: int) -> None:
        """Earmark `n` free pages without popping them off the free list."""
        if n > self.n_available:
            raise MemoryError(f"reserve({n}): only {self.n_available} "
                              "pages available")
        self.reserved += n

    def unreserve(self, n: int) -> None:
        """Release `n` reserved-but-uncommitted pages back to the pool."""
        if n > self.reserved:
            raise ValueError(f"unreserve({n}) exceeds reserved "
                             f"({self.reserved})")
        self.reserved -= n

    def alloc(self, n: int, *, reserved: bool = False) -> list:
        """Pop `n` pages off the free list (raises if short — callers gate
        admission on `can_alloc`, so running out mid-flight is a bug).
        With `reserved`, the pages commit out of the caller's reservation
        (which must cover them)."""
        if reserved:
            if n > self.reserved:
                raise ValueError(f"alloc({n}, reserved=True) exceeds "
                                 f"reserved ({self.reserved})")
            self.reserved -= n
        elif not self.can_alloc(n):
            raise MemoryError(f"alloc({n}): only {self.n_available} pages "
                              "available")
        pages = [self._free.pop() for _ in range(n)]
        self._used.update(pages)
        for p in pages:
            self._refs[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def incref(self, pages) -> None:
        """Add one holder to each in-use page (prefix sharing: a cache
        entry or a prefix-hit request pointing its table at the page).
        Referencing a page nobody holds is a bug, not a no-op."""
        for p in pages:
            if p not in self._used:
                raise ValueError(f"incref of page {p} that is not in use")
            self._refs[p] += 1

    def refcount(self, page) -> int:
        """Current holder count (0 for free pages and the scratch page)."""
        return self._refs.get(page, 0)

    def is_shared(self, page) -> bool:
        """True when more than one holder references the page (read-only
        by the copy-on-write convention)."""
        return self.refcount(page) > 1

    def free(self, pages, *, to_reserved: bool = False) -> None:
        """Drop one holder per page (decref); a page returns to the free
        list only when its last holder releases it.  With `to_reserved`,
        the page folds back into the caller's reservation (rollback) —
        refused for shared pages, which the caller does not own alone."""
        for p in pages:
            if p == SCRATCH_PAGE:
                raise ValueError("page 0 is the reserved scratch page")
            if p not in self._used:
                raise ValueError(f"double free of page {p}")
            if to_reserved and self._refs[p] > 1:
                raise ValueError(
                    f"page {p} is shared ({self._refs[p]} holders); a "
                    "rollback may only reclaim exclusively-owned pages")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                del self._refs[p]
                self._used.remove(p)
                self._free.append(p)
        if to_reserved:
            self.reserved += len(pages)

    def utilization(self) -> float:
        """Fraction of allocatable pages currently in use."""
        return self.in_use / (self.capacity - 1)
