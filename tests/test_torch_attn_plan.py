"""The arithmetic of the paged decode kernel (`csrc/paged_decode.cu`) and
of the f32 flash kernel (`csrc/flash_attention.cu`), on the CPU.

Paged decode splits each (request, KV head)'s live keys over a cluster
of up to 8 blocks: each rank takes its share of the logits and their
maxima, the ranks exchange maxima, each quantizes its own p under the
constant scale psq and sums its partial numerator and denominator, and
rank 0 adds the ranks in rank order.  The f32 flash kernel runs both
products on bf16 tensor cores: the f32 operands (q * scale, p, and f32
K and V) split exactly into three bf16 pieces, hi . hi products and the
rest summed apart, over key tiles of 64 (bf16 inputs) or 32 (f32 inputs,
six piece products).  Here, with no card:

- (a) a plain model of the split order at cluster sizes 1-8 (empty ranks
  included) against the plain version `paged_decode_attention_ref` and
  the JAX Pallas kernel in interpret mode, at `PAGED_DECODE_CARD_TOL`:
  packed fp4 and fp8 KV, hd 64 and 128, page 8 and 16, mid-page
  positions and an idle slot on the scratch page;
- (b) psq = f32(1/448) for every request with a live row (positions >=
  0), the premise of the split;
- (c) the split plan `paged_plan` at the engines' shapes, at B 1 / 32,768
  tokens, and its refusals;
- (d) the three-piece bf16 split reproduces every f32 value exactly from
  2^-110 to 3e38 (below, within 2^-133), and every p in [0, 1] above
  2^-110, with exact piece x bf16 products;
- (e) a plain model of the flash kernel's order (exact piece products,
  k16-chunked f32 sums, hi . hi apart from the rest, the kernel's key
  tiles over the live key blocks) against `flash_attention_ref` and JAX's
  `flash_attention` (interpret) at `FLASH_F32_RTOL`: bf16 inputs (path
  C's instance) and f32 inputs (K and V split too, six piece products),
  causal and window, S 256 and 200 (bk 100).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import kvcache as RKV  # noqa: E402
from repro.kernels import flash_attention as RFA  # noqa: E402
from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.core.device import batched_rowwise_dot  # noqa: E402
from repro_torch.core.kvcache import dequantize_kv  # noqa: E402
from repro_torch.core.quantize import (absmax_block_scale,  # noqa: E402
                                       quant_rows_grid)
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import paged_decode as TPD  # noqa: E402
from repro_torch.kernels.registry import PAGED_DECODE_CARD_TOL  # noqa: E402

FLASH_F32_RTOL = 2e-6          # chip_smoke.py's pin of the f32 flash route
PSQ = np.float32(1.0) * np.float32(1.0 / 448.0)
NEG_INF = -1e30


# -----------------------------------------------------------------------------
# (a)-(c) paged decode
# -----------------------------------------------------------------------------

def _paged_model(q, cache, positions, *, fmt_kv, packed, split):
    """The kernel's split order in plain PyTorch (f32): per rank the
    logits of rows [r per, (r + 1) per) and their max (-1e30 where the
    rank is empty), the global max, pg under psq = e4m3_scale(1), per-rank
    sums of pg and pg * v, folded in rank order."""
    B, _, H, hd = q.shape
    P, page, KV, _ = cache["k_codes"].shape
    G = H // KV
    table = cache["block_table"]
    view = table.shape[1] * page
    psq = absmax_block_scale(torch.ones((1, 1)), 448.0)[0, 0]
    kf = dequantize_kv(cache["k_codes"], cache["k_scale"], fmt=fmt_kv,
                       packed=packed).reshape(P * page, KV, hd)
    vf = dequantize_kv(cache["v_codes"], cache["v_scale"], fmt=fmt_kv,
                       packed=packed).reshape(P * page, KV, hd)
    qg, qs = quant_rows_grid(q[:, 0], "fp8_e4m3")
    out = torch.empty((B, H, hd))
    for b in range(B):
        n_live = min(int(positions[b]) + 1, view)
        t = torch.arange(n_live)
        rows = table[b, t // page].long() * page + t % page
        per = -(-n_live // split)
        for h in range(KV):
            hs = slice(h * G, (h + 1) * G)
            kb, vb = kf[rows, h], vf[rows, h]
            ranks = [(min(r * per, n_live), min(r * per + per, n_live))
                     for r in range(split)]
            logits = [batched_rowwise_dot(qg[b, hs], kb[t0:t1])
                      * qs[b, hs] * (hd ** -0.5) for t0, t1 in ranks]
            m = torch.stack([lg.amax(-1) if lg.shape[-1] else
                             torch.full((G,), NEG_INF) for lg in logits]
                            ).amax(0)
            num = den = None
            for (t0, t1), lg in zip(ranks, logits):
                p = torch.exp(lg - m[:, None])
                pg = torch.clamp(p / psq, -448, 448).to(
                    torch.float8_e4m3fn).float()
                n_r = batched_rowwise_dot(pg, vb[t0:t1].T.contiguous())
                d_r = pg.sum(-1)
                num = n_r if num is None else num + n_r
                den = d_r if den is None else den + d_r
            out[b, hs] = (num * psq) / torch.clamp_min(den * psq,
                                                       1e-30)[:, None]
    return out[:, None].to(q.dtype)


def _paged_caches(fmt_kv, packed, lengths, page, hd, KV, seed):
    B = len(lengths)
    S = max(-(-n // page) for n in lengths) * page
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    kw = dict(fmt=fmt_kv, packed=packed)
    ref = RKV.paged_from_contiguous(
        RKV.update_kv_cache(RKV.init_kv_cache(B, S, KV, hd, **kw),
                            jnp.asarray(k), jnp.asarray(v), 0, **kw),
        lengths, page_size=page)
    got = TKV.paged_from_contiguous(
        TKV.update_kv_cache(TKV.init_kv_cache(B, S, KV, hd, **kw),
                            torch.from_numpy(k), torch.from_numpy(v), 0,
                            **kw),
        lengths, page_size=page)
    return ref, got


KV_FORMATS = [("fp4_e2m1", True), ("fp8_e4m3", False)]


@pytest.mark.parametrize("fmt_kv,packed", KV_FORMATS)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("page", [8, 16])
def test_paged_split_model_matches_plain_and_pallas(fmt_kv, packed, hd,
                                                    page):
    KV, H = 2, 8
    # a long request, mid-page positions, a one-row request, and an idle
    # slot (position 0) whose table row is all scratch
    lengths, positions = [53, 20, 1, 9], [52, 13, 0, 0]
    ref, got = _paged_caches(fmt_kv, packed, lengths, page, hd, KV, seed=hd)
    got["block_table"][3] = 0
    ref = dict(ref, block_table=jnp.asarray(got["block_table"].numpy()))
    q = np.random.default_rng(page).standard_normal(
        (len(lengths), 1, H, hd)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    kw = dict(fmt="fp8_e4m3", fmt_kv=fmt_kv, kv_packed=packed)
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    plain = TPD.paged_decode_attention_ref(
        tq, got["k_codes"], got["k_scale"], got["v_codes"], got["v_scale"],
        got["block_table"], tpos, **kw).numpy()
    pallas = np.asarray(RFA.paged_decode_attention(
        jnp.asarray(q), ref["k_codes"], ref["k_scale"], ref["v_codes"],
        ref["v_scale"], ref["block_table"], jnp.asarray(pos), **kw))
    for split in range(1, 9):          # 8 ranks leave ranks of the 1-row
        model = _paged_model(tq, got, tpos, fmt_kv=fmt_kv, packed=packed,
                             split=split).numpy()       # request empty
        assert np.isfinite(model).all()
        for name, want in (("plain", plain), ("pallas", pallas)):
            err = float(np.max(np.abs(model - want)))
            assert err <= PAGED_DECODE_CARD_TOL, (split, name, err)


def test_psq_is_the_constant_for_every_live_request():
    """p = exp(l - max l) puts exactly 1 at the argmax, so the absmax
    scale of p, max(max(1, 1e-30) * f32(1/448), 2^-126), is f32(1/448):
    the plain version's own psq at every position >= 0, whatever the
    logits' spread."""
    assert absmax_block_scale(torch.ones((1, 1)), 448.0).item() == PSQ
    rng = np.random.default_rng(0)
    S = 64
    for pos in range(S):
        for spread in (1.0, 80.0, 1e4):
            lg = torch.from_numpy((rng.standard_normal((3, S)) * spread)
                                  .astype(np.float32))
            lg = torch.where(torch.arange(S) <= pos, lg, NEG_INF)
            p = torch.exp(lg - lg.amax(-1, keepdim=True))
            assert bool((p.amax(-1) == 1.0).all())
            _, psq = quant_rows_grid(p, "fp8_e4m3")
            assert bool((psq == torch.tensor(PSQ)).all()), (pos, spread)


ENGINE_SHAPES = [  # (B, KV, G, hd, wc, page, max_pages): qwen3-4b, granite
    (4, 8, 4, 128, 64, 16, 16), (4, 8, 2, 64, 32, 16, 16)]


@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_paged_plan_at_the_engines_shapes(shape):
    plan = TPD.paged_plan(*shape)
    assert plan.split == 7 and plan.blocks == 224 >= TPD.SMS
    assert plan.cap == -(-256 // 7)
    assert plan.smem == TPD.paged_smem_bytes(*shape[2:], plan.split)
    assert TPD.paged_plan(*shape) is plan           # memoized


def test_paged_plan_long_context_and_batch():
    # B 1 and B 2 at 32,768 tokens (2,048 pages of 16): 8 ranks of 4,096
    # rows, whose logits fit where one block's 32,768 would not
    for B in (1, 2):
        plan = TPD.paged_plan(B, 8, 4, 128, 64, 16, 2048)
        assert (plan.split, plan.cap) == (8, 4096)
        assert plan.smem <= TPD.SMEM_LIMIT
    assert TPD.paged_smem_bytes(4, 128, 64, 2048, 16, 1) > TPD.SMEM_LIMIT
    # a large batch fills the card unsplit; a short view is not split
    # below MIN_RANK_ROWS rows a rank
    assert TPD.paged_plan(64, 8, 4, 128, 64, 16, 16).split == 1
    assert TPD.paged_plan(4, 8, 4, 128, 64, 8, 4).split == 2


def test_paged_smem_layout():
    # smem_layout of paged_decode.cu by hand: table 16 ints; logits 4 x
    # 37 floats; ring max(4 x 64 x (64 + 4), 8 x 4 x 128 x 4); 7 ranks'
    # numerators and denominators
    want = 64 + 592 + 17408 + 7 * 4 * 128 * 4 + 112
    assert TPD.paged_smem_bytes(4, 128, 64, 16, 16, 7) == want


@pytest.mark.parametrize("args,what", [
    ((4, 8, 9, 128, 64, 16, 16), "H/KV"),
    ((4, 8, 4, 96, 48, 16, 16), "hd"),
    ((4, 8, 4, 128, 32, 16, 16), "hd"),
    ((0, 8, 4, 128, 64, 16, 16), "B, KV"),
    ((4, 8, 4, 128, 64, 16, 0), "B, KV"),
    ((1, 8, 8, 128, 128, 16, 4096), "does not fit"),
])
def test_paged_plan_refusals(args, what):
    with pytest.raises(ValueError, match=what):
        TPD.paged_plan(*args)


# -----------------------------------------------------------------------------
# (d) the three-piece bf16 split
# -----------------------------------------------------------------------------

def _split3(x):
    """f32 -> (hi, mid, lo), f32 tensors holding bf16 values: hi =
    bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), each difference
    exact in f32 (the kernel's split3_bf16x2)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def _sum64(pieces):
    return functools.reduce(lambda a, b: a + b, [p.double() for p in pieces])


def test_split3_is_exact_from_2e_110_to_3e38():
    rng = np.random.default_rng(0)
    n = 200_000
    e = rng.integers(-110, 128, n)
    m = rng.integers(0, 1 << 23, n)
    bits = ((e + 127) << 23 | m).astype(np.uint32)
    x = bits.view(np.float32) * rng.choice([-1, 1], n).astype(np.float32)
    x = x[np.abs(x) <= np.float32(3e38)]   # bf16 rounds past 3.39e38 to inf
    planted = np.array(
        [2.0 ** -110, 3e38, -3e38, 1.0, 1 + 2 ** -23, 1 - 2 ** -24,
         np.float32(0.1), 0.0, -0.0, 2 ** -110 * (2 - 2 ** -23),
         (2 - 2 ** -7) * 2.0 ** 127 * 0.999, 448.0 / 3],
        np.float32)
    # values whose rounding to bf16 ties, at every piece
    ties = (np.float32(1.0) + np.float32(2.0 ** -8) * np.arange(1, 9,
                                                                 2)).astype(
        np.float32)
    x = torch.from_numpy(np.concatenate([x, planted, ties]))
    pieces = _split3(x)
    assert bool((_sum64(pieces) == x.double()).all())
    assert all(bool(torch.isfinite(p).all()) for p in pieces)
    assert bool((pieces[0].to(torch.bfloat16).float() == pieces[0]).all())


def test_split3_below_2e_110_drops_under_2e_133():
    rng = np.random.default_rng(1)
    n = 50_000
    e = rng.integers(-149, -110, n)
    x = torch.from_numpy((rng.random(n) * 2.0 ** e).astype(np.float32))
    err = (_sum64(_split3(x)) - x.double()).abs()
    assert float(err.max()) < 2.0 ** -133


def test_split3_of_p_and_exact_piece_products():
    """p = exp(s - m) in [0, 1]: exact from 2^-110 on; and a piece times
    a bf16 value (8 x 8 significant bits) is exact in f32."""
    rng = np.random.default_rng(2)
    s = torch.from_numpy(-rng.exponential(8.0, 100_000).astype(np.float32))
    p = torch.cat([torch.exp(s), torch.tensor([1.0, 0.0, 2.0 ** -110])])
    live = p >= 2.0 ** -110
    pieces = _split3(p)
    assert bool((_sum64(pieces)[live] == p.double()[live]).all())
    v = torch.from_numpy(rng.standard_normal(p.numel()).astype(np.float32)
                         ).to(torch.bfloat16).float()
    for pc in pieces:
        assert bool(((pc * v).double() == pc.double() * v.double()).all())


# -----------------------------------------------------------------------------
# (e) the flash kernel's order
# -----------------------------------------------------------------------------

TILE = {1: 64, 3: 32}          # the kernel's key tile by K/V pieces
# piece pairs (q or p piece, K or V piece) of each MMA, hi . hi apart:
# with bf16 K/V one piece; f32 K/V split too, the six pairs of weight
# >= 2^-16
PAIRS = {1: [(1, 0), (2, 0)], 3: [(0, 1), (1, 0), (0, 2), (2, 0), (1, 1)]}


def _chain(acc, a, b, pairs, axis_len):
    """acc += sum over k16 chunks of a[i] . b[j] for each pair (i, j), in
    chunk order then pair order: each MMA's 16 products summed exactly and
    rounded once into the f32 accumulator.  a: pieces (..., R, K); b:
    pieces (..., K, N)."""
    for c in range(0, axis_len, 16):
        for i, j in pairs:
            part = torch.matmul(a[i][..., c:c + 16].double(),
                                b[j][..., c:c + 16, :].double())
            acc = (acc.double() + part).float()
    return acc


def _flash_model(q, k, v, *, causal, window, bq, bk):
    """The tensor-core kernel's order in plain PyTorch; with f32 k/v the
    same order over K and V split into three pieces too."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    g = H // k.shape[1]
    kv_pieces = 1 if k.dtype == torch.bfloat16 else 3
    kf = TFA._expand(k.float(), g)
    vf = TFA._expand(v.float(), g)
    ks = _split3(kf) if kv_pieces == 3 else (kf,)
    vs = _split3(vf) if kv_pieces == 3 else (vf,)
    qs = _split3(q.float() * np.float32(D ** -0.5))
    off = Sk - Sq
    out = torch.empty((B, H, Sq, D))
    hi = [(0, 0)]
    for q0 in range(0, Sq, bq):
        j0, j1 = 0, Sk // bk
        if Sq <= Sk:
            if causal:
                j1 = min(j1, (q0 + bq - 1 + off) // bk + 1)
            if window:
                j0 = max(0, q0 + off - window + 1) // bk
        kstart, kend = j0 * bk, j1 * bk
        qp = [x[:, :, q0:q0 + bq] for x in qs]
        qpos = torch.arange(q0, q0 + bq)[:, None] + off
        m = torch.full((B, H, bq, 1), NEG_INF)
        l = torch.zeros((B, H, bq, 1))
        acc = torch.zeros((B, H, bq, D))
        for k0 in range(kstart, kend, TILE[kv_pieces]):
            k1 = min(k0 + TILE[kv_pieces], kend)
            kt = [x[:, :, k0:k1].transpose(-1, -2) for x in ks]
            vt = [x[:, :, k0:k1] for x in vs]
            zero = torch.zeros((B, H, bq, k1 - k0))
            sh = _chain(zero, qp, kt, hi, D)
            sl = _chain(zero, qp, kt, PAIRS[kv_pieces], D)
            s = sh + sl
            kpos = torch.arange(k0, k1)[None, :]
            live = torch.ones((bq, k1 - k0), dtype=torch.bool)
            if causal:
                live &= kpos <= qpos
            if window:
                live &= kpos > qpos - window
            s = torch.where(live, s, NEG_INF)
            m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_cur)
            p = torch.exp(s - m_cur)
            l = l * alpha + p.sum(-1, keepdim=True)
            pp = _split3(p)
            zero = torch.zeros((B, H, bq, D))
            ph = _chain(zero, pp, vt, hi, k1 - k0)
            pl = _chain(zero, pp, vt, PAIRS[kv_pieces], k1 - k0)
            acc = acc * alpha + (ph + pl)
            m = m_cur
        out[:, :, q0:q0 + bq] = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype)


def _bf16_ulp(x):
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def _held(got, want):
    """chip_smoke.check_flash's pin: f32 relative to the largest output;
    bf16 within one ulp of each output over that."""
    err = (got.float() - want.float()).abs()
    big = float(want.float().abs().max())
    if got.dtype == torch.float32:
        return float(err.max()) / big <= FLASH_F32_RTOL, float(err.max())
    ok = bool((err <= _bf16_ulp(want.float()) + FLASH_F32_RTOL * big).all())
    return ok, float(err.max())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("S,b", [(256, 128), (200, 100)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, None)])
def test_flash_model_matches_plain_and_pallas(dtype, S, b, causal, window):
    B, H, KV, D = 1, 4, 2, 64
    rng = np.random.default_rng(S + (window or 0))
    q, k, v = (rng.standard_normal((B, h, S, D)).astype(np.float32)
               for h in (H, KV, KV))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    model = _flash_model(tq, tk, tv, causal=causal, window=window, bq=b,
                         bk=b)
    assert model.dtype == tdt and bool(torch.isfinite(model).all())
    TFA.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    plain = TFA.flash_attention_ref(tq, tk, tv, causal=causal,
                                    window=window)
    # the reference in f32 on the same values (its bf16 dot cannot run on
    # the XLA CPU), rounded to q's dtype
    jx = [jnp.asarray(x.float().numpy()) for x in (tq, tk, tv)]
    pallas = torch.from_numpy(np.array(RFA.flash_attention(
        *jx, causal=causal, window=window, bq=b, bk=b))).to(tdt)
    for name, want in (("plain", plain), ("pallas", pallas)):
        ok, err = _held(model, want)
        assert ok, (name, err)
