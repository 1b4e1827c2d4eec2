"""Quantized and paged KV cache: port vs the JAX reference, bit for bit.

The contract of `tests/test_paged_kv.py`, held across frameworks: after
the same token-by-token `paged_write_tokens` and prefill
`write_prefill_rows` writes, the port's page pools hold codes and scales
bit-identical to the reference's (jitted quantization), for fp16, bf16,
fp8 and fp4 (unpacked and packed) at odd lengths whose tails land
mid-page.  Plus the `PageAllocator` invariants.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import kvcache as TKV  # noqa: E402

RKV = importlib.import_module("repro.core.kvcache")

KV_FORMATS = [("fp16", False), ("bf16", False), ("fp8_e4m3", False),
              ("fp4_e2m1", False), ("fp4_e2m1", True)]
PS = 8
LENGTHS = [13, 5, 17]
N_KV, HD, MAX_PAGES, CAP = 2, 16, 3, 16


def _fmt_id(p):
    return f"{p[0]}{'_packed' if p[1] else ''}"


def _raw(seed, B, S):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, N_KV, HD)).astype(np.float32)
    v = rng.standard_normal((B, S, N_KV, HD)).astype(np.float32)
    return k, v


def _table():
    table = np.full((len(LENGTHS), MAX_PAGES), 0, np.int32)
    alloc = TKV.PageAllocator(CAP)
    pages = []
    for b, n in enumerate(LENGTHS):
        ids = alloc.alloc(-(-n // PS))
        table[b, :len(ids)] = ids
        pages.append(ids)
    return table, pages


_INT_VIEW = {1: np.uint8, 2: np.int16}


def _np(t):
    """Port tensor -> numpy, narrow floats as their bit patterns."""
    if t.dtype in (torch.bfloat16, torch.float16, torch.float8_e4m3fn):
        t = t.view({1: torch.uint8, 2: torch.int16}[t.element_size()])
    return t.numpy()


def _jnp(a):
    """Reference array -> numpy, narrow floats as their bit patterns."""
    a = np.asarray(a)
    return a.view(_INT_VIEW[a.dtype.itemsize]) \
        if a.dtype.itemsize < 4 and a.dtype != np.uint8 else a


def _assert_pools_equal(got, want):
    for key in TKV.QUANT_KEYS:
        g, w = _np(got[key]), _jnp(want[key])
        assert g.shape == w.shape, key
        np.testing.assert_array_equal(g, w, err_msg=key)


@pytest.mark.parametrize("fmt,packed", KV_FORMATS,
                         ids=map(_fmt_id, KV_FORMATS))
def test_paged_token_writes_bit_identical_to_jax(fmt, packed):
    B = len(LENGTHS)
    k, v = _raw(0, B, MAX_PAGES * PS)
    table, _ = _table()
    ref = dict(RKV.init_paged_kv_cache(CAP, PS, N_KV, HD, fmt=fmt,
                                       packed=packed),
               block_table=jnp.asarray(table))
    got = dict(TKV.init_paged_kv_cache(CAP, PS, N_KV, HD, fmt=fmt,
                                       packed=packed),
               block_table=torch.from_numpy(table))
    write = jax.jit(functools.partial(RKV.paged_write_tokens, fmt=fmt,
                                      packed=packed))
    for t in range(max(LENGTHS)):
        # idle rows write position 0 of a scratch table row, as the
        # engine's fixed-shape step does
        live = np.array([t < n for n in LENGTHS])
        pos = np.where(live, t, 0).astype(np.int32)
        tab = np.where(live[:, None], table, 0).astype(np.int32)
        ref["block_table"] = jnp.asarray(tab)
        got["block_table"] = torch.from_numpy(tab)
        ref = write(ref, jnp.asarray(k[:, t:t + 1]),
                    jnp.asarray(v[:, t:t + 1]), jnp.asarray(pos))
        TKV.paged_write_tokens(got, torch.from_numpy(k[:, t:t + 1]),
                               torch.from_numpy(v[:, t:t + 1]),
                               torch.from_numpy(pos), fmt=fmt,
                               packed=packed)
    # the scratch page's contents depend on write order: compare the rest
    for key in TKV.QUANT_KEYS:
        ref[key] = ref[key][1:]
        got[key] = got[key][1:]
    _assert_pools_equal(got, ref)


@pytest.mark.parametrize("fmt,packed", KV_FORMATS,
                         ids=map(_fmt_id, KV_FORMATS))
def test_prefill_scatter_and_gather_bit_identical_to_jax(fmt, packed):
    B, S = len(LENGTHS), MAX_PAGES * PS
    k, v = _raw(1, B, S)
    upd = jax.jit(functools.partial(RKV.update_kv_cache, offset=0, fmt=fmt,
                                    packed=packed))
    ref_c = upd(RKV.init_kv_cache(B, S, N_KV, HD, fmt=fmt, packed=packed),
                jnp.asarray(k), jnp.asarray(v))
    got_c = TKV.update_kv_cache(
        TKV.init_kv_cache(B, S, N_KV, HD, fmt=fmt, packed=packed),
        torch.from_numpy(k), torch.from_numpy(v), 0, fmt=fmt, packed=packed)
    _assert_pools_equal(got_c, ref_c)
    table, pages = _table()
    ref = RKV.init_paged_kv_cache(CAP, PS, N_KV, HD, fmt=fmt, packed=packed)
    got = TKV.init_paged_kv_cache(CAP, PS, N_KV, HD, fmt=fmt, packed=packed)
    for b, n in enumerate(LENGTHS):
        # a split scatter (start=) lands the same rows as a whole one
        mid = n // 2
        for lo, hi in ((0, mid), (mid, n)):
            ref = RKV.write_prefill_rows(
                ref, {key: ref_c[key][b, :hi] for key in RKV.QUANT_KEYS},
                pages[b], hi, start=lo)
            TKV.write_prefill_rows(
                got, {key: got_c[key][b, :hi] for key in TKV.QUANT_KEYS},
                pages[b], hi, start=lo)
    _assert_pools_equal(got, ref)
    ref["block_table"] = jnp.asarray(table)
    got["block_table"] = torch.from_numpy(table)
    rv, gv = RKV.gather_paged_kv(ref), TKV.gather_paged_kv(got)
    for key in TKV.QUANT_KEYS:
        for b, n in enumerate(LENGTHS):
            np.testing.assert_array_equal(_np(gv[key][b, :n]),
                                          _jnp(rv[key][b, :n]))
            np.testing.assert_array_equal(_np(gv[key][b, :n]),
                                          _np(got_c[key][b, :n]))
    # the relayout fixture is the same pure relayout
    fx = TKV.paged_from_contiguous(got_c, LENGTHS, page_size=PS)
    fv = TKV.gather_paged_kv(fx)
    for key in TKV.QUANT_KEYS:
        for b, n in enumerate(LENGTHS):
            np.testing.assert_array_equal(_np(fv[key][b, :n]),
                                          _np(got_c[key][b, :n]))
    # and dequantization round-trips to the same f32 values
    kd, _ = TKV.dequantize_cache(got_c, fmt=fmt, packed=packed)
    kr, _ = RKV.dequantize_cache(ref_c, fmt=fmt, packed=packed)
    np.testing.assert_array_equal(kd.numpy().view(np.uint32),
                                  np.asarray(kr).view(np.uint32))


def test_byte_accounting_matches_reference():
    for fmt, packed in KV_FORMATS:
        assert TKV.kv_cache_nbytes(3, 40, 2, 16, fmt=fmt, packed=packed) == \
            RKV.kv_cache_nbytes(3, 40, 2, 16, fmt=fmt, packed=packed)
        assert TKV.paged_kv_cache_nbytes(35, 5, 8, 2, 16, fmt=fmt,
                                         packed=packed) == \
            RKV.paged_kv_cache_nbytes(35, 5, 8, 2, 16, fmt=fmt,
                                      packed=packed)


def test_write_prefill_rows_rejects_bad_ranges():
    pool = TKV.init_paged_kv_cache(4, PS, N_KV, HD, fmt="fp8_e4m3")
    rows = TKV.init_kv_cache(1, 24, N_KV, HD, fmt="fp8_e4m3")
    rows = {k: v[0] for k, v in rows.items()}
    with pytest.raises(ValueError, match="pages"):
        TKV.write_prefill_rows(pool, rows, [1], 17)
    with pytest.raises(ValueError, match="start"):
        TKV.write_prefill_rows(pool, rows, [1, 2, 3], 17, start=18)


def test_page_allocator_invariants():
    a = TKV.PageAllocator(6)
    assert a.n_free == 5 and a.in_use == 0
    p = a.alloc(3)
    assert p == [1, 2, 3] and a.in_use == 3 and a.peak_in_use == 3
    a.free([2])
    assert a.alloc(1) == [2]                       # LIFO reuse
    with pytest.raises(MemoryError):
        a.alloc(3)
    with pytest.raises(ValueError, match="scratch"):
        a.free([0])
    a.free([1])
    with pytest.raises(ValueError, match="double free"):
        a.free([1])
    # refcounts: a shared page survives one holder's free
    a.incref([3])
    assert a.refcount(3) == 2 and a.is_shared(3)
    a.free([3])
    assert a.refcount(3) == 1 and a.in_use == 2
    with pytest.raises(ValueError, match="not in use"):
        a.incref([5])
    # reservations: reserved pages stay on the free list, out of reach
    a.reserve(2)
    assert a.n_available == a.n_free - 2
    assert not a.can_alloc(a.n_free - 1)
    got = a.alloc(1, reserved=True)
    assert a.reserved == 1
    a.free(got, to_reserved=True)
    assert a.reserved == 2
    with pytest.raises(ValueError):
        a.unreserve(3)
    a.unreserve(2)
    a.free([2, 3])
    assert a.in_use == 0 and a.utilization() == 0.0
    with pytest.raises(ValueError):
        TKV.PageAllocator(1)


# a captured step's offset is a 0-dim device tensor: S_NEW rows written at
# offsets inside the cache, at its last fitting start, past either end,
# and negative (counted from the end, then clamped, as the reference's
# dynamic_update_slice does)
S_CTX, S_NEW = 16, 3
OFFSETS = [0, 5, S_CTX - S_NEW, S_CTX - 1, -1, -3, -S_CTX - 2, 40]


@functools.lru_cache(maxsize=None)
def _ref_update(fmt, packed):
    return jax.jit(functools.partial(RKV.update_kv_cache, fmt=fmt,
                                     packed=packed))


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("fmt,packed", KV_FORMATS,
                         ids=map(_fmt_id, KV_FORMATS))
def test_update_kv_cache_tensor_offset_bit_identical(fmt, packed, offset):
    B = 2
    base_k, base_v = _raw(2, B, S_CTX)
    k, v = _raw(3, B, S_NEW)
    kw = dict(fmt=fmt, packed=packed)

    def filled():               # every row holds codes before the write
        return TKV.update_kv_cache(
            TKV.init_kv_cache(B, S_CTX, N_KV, HD, **kw),
            torch.from_numpy(base_k), torch.from_numpy(base_v), 0, **kw)

    by_int = TKV.update_kv_cache(filled(), torch.from_numpy(k),
                                 torch.from_numpy(v), offset, **kw)
    by_tensor = TKV.update_kv_cache(
        filled(), torch.from_numpy(k), torch.from_numpy(v),
        torch.tensor(offset, dtype=torch.int32), **kw)
    for key in TKV.QUANT_KEYS:
        np.testing.assert_array_equal(_np(by_tensor[key]), _np(by_int[key]),
                                      err_msg=key)
    upd = _ref_update(fmt, packed)
    ref = upd(RKV.init_kv_cache(B, S_CTX, N_KV, HD, **kw),
              jnp.asarray(base_k), jnp.asarray(base_v), jnp.int32(0))
    ref = upd(ref, jnp.asarray(k), jnp.asarray(v), jnp.int32(offset))
    _assert_pools_equal(by_tensor, ref)
