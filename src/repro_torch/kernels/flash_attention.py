"""Blocked prefill attention: the plain PyTorch versions and the wrappers
around the CUDA kernels (`csrc/flash_attention.cu`, `csrc/dpa_flash.cu`).

`flash_attention` replaces the Pallas TPU kernel
`repro/kernels/flash_attention.py` `flash_attention`: f32 online-softmax
attention over (B, H, Sq, D) queries and (B, Hkv, Sk, D) keys and values
(GQA: q head h reads kv head h // (H / Hkv)), causal and sliding-window
masks, output in q's dtype.  On the card both products run on bf16
tensor cores, each f32 operand (scaled q, p, and f32 K and V) split into
three bf16 pieces: bf16 inputs' products are exact; f32 inputs first go
through a pre-pass that splits K and V (`prepass_launches`), and keep
the six piece products of weight 2^-16 or more.

`dpa_flash_attention` replaces `dpa_flash_attention` of the same file:
both attention products accumulate in f32 over quantized operands.  q
is quantized per row onto the fmt grid; K and V either arrive raw and
are quantized per row onto the fmt_kv grid, or arrive as quantized cache
rows (codes plus per-row f32 scales, E2M1 optionally packed along the
head dim) and are widened; the probabilities are quantized per (row, key
block of `bk`) after the exp under the running max, their scale folded
into the numerator and the denominator.  `bk` is part of the numerics.
On the card the attention format (q's and p's grid) is E4M3, E2M1 or
fp16 (`_ATTN_FMT`) over E4M3, E2M1 or fp16 K/V; raw K/V are quantized
once by the row-quantizer kernels (`kernels.quantize`) into the codes
and scales a quantized cache holds, and the kernel reads those.  Head
dims 64 and 128 take q blocks of up to 128 rows; 256 (recurrentgemma's
local attention) up to 64 (`max_bq`), the kernel's other layout; the
f32 kernel has no hd-256 instance yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import batched_rowwise_dot
from repro_torch.core.kvcache import dequantize_kv
from repro_torch.core.quantize import quant_rows_grid
from repro_torch.kernels import build, census
from repro_torch.kernels.quantize import quantize_pack_rows, quantize_rows

NEG_INF = -1e30
KERNEL_HEAD_DIMS = (64, 128)     # the f32 kernel's head-dim instances
DPA_HEAD_DIMS = (64, 128, 256)   # the DPA kernel's
MAX_BLOCK = 128                  # the kernels' tile: bq, bk <= 128
DPA_WIDE_BQ = 64                 # the DPA kernel's q rows a block at hd 256
F32_WIDE_ITEM = ("ROADMAP Queue 2, flash_attention (the f32 flash kernel) "
                 "at head dim 256")

# the DPA kernel's K/V code layouts: (fmt_kv, packed) -> kv_fmt, and its
# attention formats (dpa_common.cuh kGrid*)
_KV_FMT = {("fp8_e4m3", False): 0, ("fp4_e2m1", False): 1,
           ("fp4_e2m1", True): 2, ("fp16", False): 3}
_ATTN_FMT = {f: build.GRID_CODES[f] for f in ("fp8_e4m3", "fp4_e2m1",
                                              "fp16")}
DPA_FORMATS_ITEM = ("ROADMAP Queue 2 under dpa_flash_attention (formats "
                    "open: f32 attention over quantized K/V, bf16 and E5M2)")


def _mask(sq: int, sk: int, causal: bool, window, device):
    """(Sq, Sk) bool, live = True; query i sits at key position
    i + Sk - Sq."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def _expand(t, g: int):
    return t.repeat_interleave(g, dim=1) if g > 1 else t


def flash_attention_ref(q, k, v, *, causal: bool = True, scale=None,
                        window=None):
    """Plain version (port of `repro.kernels.ref.flash_attention_ref`): f32
    logits times the scale, masked to -1e30, softmax as exp(x - max) / sum,
    f32 product with V; out in q's dtype."""
    B, H, Sq, D = q.shape
    g = H // k.shape[1]
    sc = scale if scale is not None else D ** -0.5
    kf = _expand(k.to(torch.float32), g)
    vf = _expand(v.to(torch.float32), g)
    logits = batched_rowwise_dot(q.to(torch.float32), kf) * sc
    mask = _mask(Sq, k.shape[2], causal, window, q.device)
    logits = torch.where(mask, logits, NEG_INF)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    return batched_rowwise_dot(probs, vf.transpose(-1, -2)).to(q.dtype)


def dpa_flash_attention_ref(q, k, v, k_scale=None, v_scale=None, *, fmt: str,
                            fmt_kv=None, kv_quant: bool = False,
                            kv_packed: bool = False, causal: bool = True,
                            window=None, scale=None, bk: int = 128,
                            p_codes=None):
    """Plain version (port of `repro.kernels.ref.dpa_flash_attention_ref`,
    plus the kernel's cache mode): the key-block loop of the kernel —
    running max, alpha rescale, p quantized per (row, key block).

    `p_codes`, a check-only output: a zeroed (B, H, Sq, Sk) tensor that
    receives the code of every quantized probability (`p_code_dtype`: the
    E4M3 byte of an E4M3 or E2M1 value, fp16 at fp16)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    g = H // k.shape[1]
    sc = float(scale if scale is not None else D ** -0.5)
    kf = fmt_kv or fmt
    qg, qs = quant_rows_grid(q, fmt)
    if kv_quant:
        k_eff = dequantize_kv(k, k_scale, fmt=kf, packed=kv_packed)
        v_eff = dequantize_kv(v, v_scale, fmt=kf, packed=kv_packed)
    else:
        kg, ks = quant_rows_grid(k, kf)
        vg, vs = quant_rows_grid(v, kf)
        k_eff, v_eff = kg * ks, vg * vs
    k_eff, v_eff = _expand(k_eff, g), _expand(v_eff, g)
    mask = _mask(Sq, Sk, causal, window, q.device)
    m = torch.full((B, H, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for j0 in range(0, Sk, bk):
        s = batched_rowwise_dot(qg, k_eff[:, :, j0:j0 + bk]) * qs * sc
        s = torch.where(mask[:, j0:j0 + bk], s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_cur)
        alpha = torch.exp(m - m_cur)
        pg, ps = quant_rows_grid(p, fmt)
        if p_codes is not None:
            p_codes[..., j0:j0 + bk] = (
                pg.to(torch.float16) if fmt == "fp16" else
                pg.to(torch.float8_e4m3fn).view(torch.uint8))
        l = l * alpha + pg.sum(dim=-1, keepdim=True) * ps
        acc = acc * alpha + batched_rowwise_dot(
            pg, v_eff[:, :, j0:j0 + bk].transpose(-1, -2)) * ps
        m = m_cur
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def p_code_dtype(fmt: str):
    """The dtype of `p_codes` at attention format fmt."""
    return torch.float16 if fmt == "fp16" else torch.uint8


def _blocks(q, k, bq: int, bk: int):
    """bq, bk cut to the sequence lengths, which they must divide."""
    Sq, Sk = q.shape[2], k.shape[2]
    bq, bk = min(bq, Sq), min(bk, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"blocks must divide the sequence: Sq={Sq} bq={bq}, "
                         f"Sk={Sk} bk={bk}")
    return bq, bk


def _check(q, k, v, dk: int):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q (B, H, Sq, D) and k/v (B, Hkv, Sk, D'): got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, _ = q.shape
    if k.shape[0] != B or H % k.shape[1] or k.shape[3] != dk:
        raise ValueError(f"k/v {tuple(k.shape)} do not serve q "
                         f"{tuple(q.shape)} (head width {dk})")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k and v must share one device")


def max_bq(head_dim: int) -> int:
    """The DPA kernel's largest q block at this head dim: 128, or 64 at
    hd 256, where 128 rows do not fit its shared memory (`bq` is free:
    rows are independent; `bk` is part of the numerics)."""
    return DPA_WIDE_BQ if head_dim == 256 else MAX_BLOCK


def _check_launch(q, bq, bk, window, tensors, what, head_dims):
    """Raise for what the kernels do not take (CUDA operands only)."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, _, D = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes f32/bf16 q, got {q.dtype}")
    if D not in head_dims:
        raise ValueError(f"{what} kernel needs hd in {head_dims}, got {D}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if bq > max_bq(D) or bk > MAX_BLOCK or B * H > 65535:
        raise ValueError(f"{what} kernel needs bq <= {max_bq(D)}, bk <= "
                         f"{MAX_BLOCK} and B * H <= 65535; got bq={bq}, "
                         f"bk={bk}, B={B}, H={H}")
    if not all(t.is_contiguous() for t in tensors if t is not None):
        raise ValueError(f"{what} kernel needs contiguous operands")


def _stream(q):
    return torch.cuda.current_stream(q.device).cuda_stream


def flash_attention(q, k, v, *, causal: bool = True, window=None,
                    scale=None, bq: int = 128, bk: int = 128):
    """(B, H, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D) -> (B, H, Sq, D) in
    q's dtype; bq and bk (cut to the lengths) must divide Sq and Sk.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `flash_attention.launches` counts launches,
    `.prepass_launches` the f32 inputs' K/V splits (two a call), and the
    census (`kernels.census`) the work of each."""
    build.forward_only("flash_attention", q, k, v)
    _check(q, k, v, q.shape[3])
    bq, bk = _blocks(q, k, bq, bk)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                                   window=window)
    if q.shape[3] == 256:
        raise NotImplementedError(
            f"flash_attention kernel has no head-dim 256 instance: open in "
            f"{F32_WIDE_ITEM}")
    _check_launch(q, bq, bk, window, (q, k, v), "flash_attention",
                  KERNEL_HEAD_DIMS)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes k/v in q's dtype "
                        f"{q.dtype}, got {k.dtype}, {v.dtype}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs 16-byte aligned "
                         "operands")
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1:3]
    lib = build.load_library()
    if q.dtype == torch.float32:
        k, v = _split_pieces(lib, k), _split_pieces(lib, v)
        split = census.launch_work("flash_attention", "prepass",
                                   rows=B * KV * Sk, hd=D)
        for _ in range(2):
            census.count(flash_attention, split, "prepass", own=False)
    out = torch.empty_like(q)
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        int(q.dtype == torch.bfloat16), D, B, H, k.shape[1], Sq,
        k.shape[-2], bq, bk, int(causal), int(window or 0),
        float(scale if scale is not None else D ** -0.5), _stream(q))
    build.check(err, "flash_attention")
    census.count(flash_attention, census.launch_work(
        "flash_attention", B=B, H=H, KV=KV, sq=Sq, sk=Sk, hd=D,
        elem=q.element_size(), causal=bool(causal), window=window or None))
    return out


def _split_pieces(lib, x):
    """f32 (B, Hkv, S, D) K or V -> its (B, Hkv, 3, S, D) bf16 pieces hi,
    mid, lo (hi + mid + lo = x, exact for |x| >= 2^-110), the f32
    instance's pre-pass."""
    B, Hkv, S, D = x.shape
    out = torch.empty((B, Hkv, 3, S, D), dtype=torch.bfloat16,
                      device=x.device)
    build.check(lib.flash_kv_split_launch(x.data_ptr(), out.data_ptr(),
                                          B * Hkv, S * D, _stream(x)),
                "flash_attention pre-pass")
    return out


census.declare(flash_attention, "prepass")


def dpa_flash_attention(q, k, v, k_scale=None, v_scale=None, *, fmt: str,
                        fmt_kv=None, kv_quant: bool = False,
                        kv_packed: bool = False, causal: bool = True,
                        window=None, scale=None, bq: int = 128,
                        bk: int = 128, p_codes=None):
    """(B, H, Sq, D) x (B, Hkv, Sk, Dk) x (B, Hkv, Sk, Dk) -> (B, H, Sq, D)
    in q's dtype.  Raw mode (`kv_quant` False): k/v are float tensors.
    Cache mode: k/v are cache codes (float8_e4m3fn, float16, or uint8 E2M1
    codes, Dk = D / 2 when `kv_packed`) with (B, Hkv, Sk, 1) f32 row
    scales.
    `p_codes`: see `dpa_flash_attention_ref` (a check only).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises: raw K/V first go through `_prepass` (two row
    quantizer launches).  `dpa_flash_attention.launches` counts launches,
    `.prepass_launches` those on raw K/V, and the census
    (`kernels.census`) their work (the pre-pass's own launches are the
    row quantizers')."""
    build.forward_only("dpa_flash_attention", q, k, v, k_scale, v_scale)
    fmt_kv = fmt_kv or fmt
    D = q.shape[3]
    _check(q, k, v, D // 2 if kv_quant and kv_packed else D)
    bq, bk = _blocks(q, k, bq, bk)
    kw = dict(fmt=fmt, fmt_kv=fmt_kv, kv_quant=kv_quant, kv_packed=kv_packed,
              causal=causal, window=window, scale=scale)
    if q.device.type == "cpu":
        return dpa_flash_attention_ref(q, k, v, k_scale, v_scale, bk=bk,
                                       p_codes=p_codes, **kw)
    if fmt not in _ATTN_FMT or (fmt_kv, False) not in _KV_FMT:
        raise NotImplementedError(
            f"dpa_flash_attention kernel serves {sorted(_ATTN_FMT)} "
            f"attention over fp8_e4m3, fp4_e2m1 or fp16 K/V (raw, cache "
            f"codes, packed fp4); (fmt={fmt}, fmt_kv={fmt_kv}, kv_quant="
            f"{kv_quant}, kv_packed={kv_packed}) is open in "
            f"{DPA_FORMATS_ITEM}")
    _check_launch(q, bq, bk, window, (q, k, v, k_scale, v_scale, p_codes),
                  "dpa_flash_attention", DPA_HEAD_DIMS)
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1:3]
    if p_codes is not None and (p_codes.dtype != p_code_dtype(fmt) or
                                p_codes.shape != (B, H, Sq, Sk)):
        raise ValueError(f"p_codes must be a (B, H, Sq, Sk) "
                         f"{p_code_dtype(fmt)} tensor")
    packed = bool(kv_quant and kv_packed)
    kv_row_bytes = k.shape[-1] * k.element_size() + (4 if kv_quant else 0)
    if kv_quant:
        want = {"fp8_e4m3": torch.float8_e4m3fn, "fp16": torch.float16,
                "fp4_e2m1": torch.uint8}[fmt_kv]
        if k.dtype != want or v.dtype != want:
            raise TypeError(f"{fmt_kv} cache codes must be {want}, got "
                            f"{k.dtype}, {v.dtype}")
        for s in (k_scale, v_scale):
            if s is None or s.shape != (B, Hkv, Sk, 1) or \
                    s.dtype != torch.float32:
                raise ValueError(f"cache mode needs ({B}, {Hkv}, {Sk}, 1) "
                                 "f32 k_scale and v_scale")
        if (k.data_ptr() | v.data_ptr()) % 16:
            raise ValueError("dpa_flash_attention kernel needs 16-byte "
                             "aligned cache codes")
    else:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"raw k/v must be in q's dtype {q.dtype}, got "
                            f"{k.dtype}, {v.dtype}")
        k, k_scale = _prepass(k, fmt_kv)
        v, v_scale = _prepass(v, fmt_kv)
        packed = fmt_kv == "fp4_e2m1"
    out = torch.empty_like(q)
    err = build.load_library().dpa_flash_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(),
        v.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), None if p_codes is None else p_codes.data_ptr(), D,
        _KV_FMT[(fmt_kv, packed)], _ATTN_FMT[fmt], B, H, Hkv, Sq, Sk, bq, bk,
        int(causal),
        int(window or 0), float(scale if scale is not None else D ** -0.5),
        _stream(q))
    build.check(err, "dpa_flash_attention")
    census.count(dpa_flash_attention, census.launch_work(
        "dpa_flash_attention", B=B, H=H, KV=Hkv, sq=Sq, sk=Sk, hd=D,
        q_bytes=q.element_size(), kv_row_bytes=kv_row_bytes,
        causal=bool(causal), window=window or None, fmt=fmt),
        *(() if kv_quant else ("prepass",)))
    return out


def _prepass(x, fmt_kv):
    """Raw (B, Hkv, Sk, D) K or V quantized once per row by the row
    quantizers' kernels: -> (E4M3 or fp16 codes, or E2M1 codes packed two
    per byte along D; (B, Hkv, Sk, 1) f32 scales), the rows
    `core.kvcache.quantize_kv` writes for the same values (E2M1's negative
    zero aside: the cache writes code 0 where the quantizer keeps code 8,
    both the value 0)."""
    rows = x.reshape(-1, x.shape[-1])
    if fmt_kv in ("fp8_e4m3", "fp16"):
        codes, scales = quantize_rows(rows, fmt=fmt_kv)
    else:
        codes, scales = quantize_pack_rows(rows)
    return (codes.view(x.shape[:-1] + (codes.shape[-1],)),
            scales.view(x.shape[:-1] + (1,)))


census.declare(dpa_flash_attention, "prepass")
