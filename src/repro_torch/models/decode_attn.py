"""Decode-side DPA attention (port of `repro.models.decode_attn`).

QK^T and PV accumulate in f32 over operands absmax-quantized onto a
Table-I format grid, and the softmax max/denominator stay f32.
`dpa_paged_decode_attn` is the serving engine's variant: K/V codes are
read through the block table of the paged cache, with a per-request
causal mask.  These are the plain routes of the `flash_attn`,
`decode_attn` and `paged_decode` ops, and the plain version the CUDA
paged-decode kernel is held against.

Products are summed with `batched_rowwise_dot`, so query row i of a
prefill chunk reduces exactly like the same row in a single-token decode
step (the engine-vs-`generate` pin depends on it).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import batched_rowwise_dot
from repro_torch.core.kvcache import (dequantize_cache, dequantize_kv,
                                      gather_paged_kv)
from repro_torch.core.quantize import quant_rows_grid

NEG_INF = -1e30


def build_sdpa_mask(sq: int, skv: int, offset, causal: bool, window,
                    valid=None, device="cpu"):
    """(Sq, Skv) bool mask: offset is the index of q position 0 within the
    kv timeline (an int, or a 0-dim integer tensor on `device`, which a
    captured step reads at every replay); window a local attention width;
    valid an extra (Skv,) key-slot mask."""
    qpos = _scalar(offset) + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None and window > 0:
        mask = mask & (kpos > qpos - window)
    if valid is not None:
        mask = mask & valid[None, :]
    return mask


def _scalar(offset):
    """A scalar offset as a Python int, or as the 0-dim tensor it is."""
    return offset if torch.is_tensor(offset) else int(offset)


def _heads_first(t):
    return t.permute(0, 2, 1, 3)                  # (B,S,H,d) -> (B,H,S,d)


def sdpa_reference(q, k, v, mask, *, scale):
    """The f32 attention datapath: f32 logits and softmax over
    compute-dtype operands, GQA expansion, output in q's dtype."""
    g = q.shape[2] // k.shape[2]
    kh = k.repeat_interleave(g, dim=2)
    vh = v.repeat_interleave(g, dim=2)
    logits = batched_rowwise_dot(_heads_first(q), _heads_first(kh)) * scale
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = batched_rowwise_dot(probs, vh.permute(0, 2, 3, 1))   # (B,H,S,hd)
    return _heads_first(out).to(q.dtype)


def dpa_attention(q, k, v, mask, *, fmt: str, fmt_kv=None, scale,
                  kv_on_grid: bool = False):
    """DPA attention over grouped K/V (any shape).

    q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd); mask broadcastable to
    (B,H,Sq,Skv).  With `kv_on_grid` k/v already hold dequantized cache
    values; otherwise they are quantized per row onto fmt_kv's grid here.
    Quantization happens before the GQA expansion, and the op order is
    the reference's."""
    g = q.shape[2] // k.shape[2]
    qg, qs = quant_rows_grid(q, fmt)                   # (B,Sq,H,hd/1)
    if kv_on_grid:
        k_eff, v_eff = k.to(torch.float32), v.to(torch.float32)
    else:
        kf = fmt_kv or fmt
        kg, ks = quant_rows_grid(k, kf)
        vg, vs = quant_rows_grid(v, kf)
        k_eff, v_eff = kg * ks, vg * vs
    if g > 1:
        k_eff = k_eff.repeat_interleave(g, dim=2)      # (B,Skv,H,hd)
        v_eff = v_eff.repeat_interleave(g, dim=2)
    logits = batched_rowwise_dot(_heads_first(qg), _heads_first(k_eff))
    logits = logits * _heads_first(qs) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)                          # f32 softmax core
    pg, ps = quant_rows_grid(p, fmt)
    den = pg.sum(dim=-1, keepdim=True) * ps            # f32 denominator
    num = batched_rowwise_dot(pg, v_eff.permute(0, 2, 3, 1))  # (B,H,Sq,hd)
    num = _heads_first(num) * _heads_first(ps)
    out = num / _heads_first(torch.clamp_min(den, 1e-30))
    return out.to(q.dtype)


def dpa_decode_attn(q, cache, offset, *, fmt: str, fmt_kv: str,
                    kv_packed: bool, scale):
    """One decode step against a contiguous quantized cache; causal
    masking via `offset` (an int or a 0-dim integer tensor)."""
    k, v = dequantize_cache(cache, fmt=fmt_kv, packed=kv_packed)
    valid = torch.arange(k.shape[1], device=q.device) <= _scalar(offset)
    return dpa_attention(q, k, v, valid[None, None, None, :], fmt=fmt,
                         scale=scale, kv_on_grid=True)


def dpa_paged_decode_attn(q, cache, positions, *, fmt: str, fmt_kv: str,
                          kv_packed: bool, scale):
    """One decode step against the paged quantized cache: the block table
    gathers each request's pages into timeline order (pure relayout), the
    rows widen, and row b attends key slots <= positions[b]."""
    view = gather_paged_kv(cache)
    k = dequantize_kv(view["k_codes"], view["k_scale"], fmt=fmt_kv,
                      packed=kv_packed)
    v = dequantize_kv(view["v_codes"], view["v_scale"], fmt=fmt_kv,
                      packed=kv_packed)
    kpos = torch.arange(k.shape[1], device=q.device)
    valid = kpos[None, :] <= positions.to(torch.int64)[:, None]
    return dpa_attention(q, k, v, valid[:, None, None, :], fmt=fmt,
                         scale=scale, kv_on_grid=True)
