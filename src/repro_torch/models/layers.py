"""Layer library of the port's dense decoder (port of the parts of
`repro.models.layers` the serving path runs).

Every projection goes through `core.linear.apply_linear` (the DPA
contract) and every attention/unembed through an `exec_plan` route, so
this module carries no policy-mode branching.  Layers are functions over
a params dict; decode paths carry explicit caches, updated in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import exec_plan
from repro_torch.core import kvcache as KV
from repro_torch.core.linear import apply_linear, init_linear
from repro_torch.core.policy import get_policy
from repro_torch.core.quantize import recip

# -----------------------------------------------------------------------------
# norms
# -----------------------------------------------------------------------------


def init_norm(d: int, device="cpu"):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_norm(params, x, *, eps: float = 1e-5):
    """RMSNorm in f32; the mean is a sum times f32(1/d), as the jitted
    reference computes it."""
    xf = x.to(torch.float32)
    ms = (xf * xf).sum(dim=-1, keepdim=True) * recip(xf.shape[-1])
    y = xf * torch.rsqrt(ms + eps) * params["scale"]
    return y.to(x.dtype)


# -----------------------------------------------------------------------------
# rotary position embedding
# -----------------------------------------------------------------------------

def rope(x, positions, theta: float):
    """x: (B, S, H, hd); positions: (S,) or (B, S) integer positions (the
    latter for per-request timelines in the batched decode step)."""
    hd = x.shape[-1]
    half = hd // 2
    idx = torch.arange(half, dtype=torch.float32, device=x.device)
    freqs = torch.exp(-math.log(theta) * idx * recip(half))
    ang = positions.to(torch.float32)[..., None] * freqs
    if ang.ndim == 3:                                   # (B, S, half)
        cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    else:
        cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -----------------------------------------------------------------------------
# attention (GQA, qk-norm, KV caches)
# -----------------------------------------------------------------------------

def init_attention(generator, cfg, device="cpu"):
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": init_linear(generator, d, cfg.n_heads * hd, device=device),
        "wk": init_linear(generator, d, cfg.n_kv_heads * hd, device=device),
        "wv": init_linear(generator, d, cfg.n_kv_heads * hd, device=device),
        "wo": init_linear(generator, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, device)
        p["k_norm"] = init_norm(hd, device)
    return p


def _sdpa(q, k, v, *, causal, window, offset, valid=None, policy=None,
          kv_on_grid=False):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd), through the
    `flash_attn` route the plan resolves."""
    policy = get_policy(policy if policy is not None else "fp32")
    entry = exec_plan.resolve("flash_attn", policy, sq=q.shape[1],
                              skv=k.shape[1], has_valid=valid is not None,
                              kv_on_grid=kv_on_grid)
    return entry.run(q, k, v, policy=policy, causal=causal, window=window,
                     offset=offset, valid=valid, scale=q.shape[-1] ** -0.5,
                     kv_on_grid=kv_on_grid)


def _positions(offset, B, Sq, device):
    """(B, Sq) per-request positions for a (B,) offset vector, else the
    (Sq,) positions after a scalar offset."""
    if torch.is_tensor(offset) and offset.ndim == 1:
        return offset.to(device=device, dtype=torch.int64)[:, None] \
            + torch.arange(Sq, device=device)[None]
    return int(offset) + torch.arange(Sq, device=device)


def apply_attention(params, x, cfg, *, offset=0, cache=None):
    """Returns (y, cache).  Cache layouts: the paged quantized pool (with
    "block_table"; `offset` a (B,) position vector), the contiguous
    quantized cache ("k_codes"), the raw full cache ("k"), or none."""
    policy = get_policy(cfg.policy)
    B, Sq, _ = x.shape
    hd = cfg.hd
    q = apply_linear(params["wq"], x, policy).reshape(B, Sq, cfg.n_heads, hd)
    k = apply_linear(params["wk"], x, policy).reshape(B, Sq, cfg.n_kv_heads,
                                                      hd)
    v = apply_linear(params["wv"], x, policy).reshape(B, Sq, cfg.n_kv_heads,
                                                      hd)
    if "q_norm" in params:
        q = apply_norm(params["q_norm"], q, eps=cfg.norm_eps)
        k = apply_norm(params["k_norm"], k, eps=cfg.norm_eps)
    if cfg.rope_theta > 0:
        pos = _positions(offset, B, Sq, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)

    scale = hd ** -0.5
    kv_on_grid = False
    if cache is not None and "block_table" in cache:
        # the continuous-batching engine's paged pool: new tokens quantize
        # into each request's pages, attention reads codes through the
        # block table (decode steps only; prefill runs against the
        # contiguous staging cache)
        if Sq != 1:
            raise NotImplementedError(
                "multi-token paged attention is the speculative verify "
                "pass (ROADMAP Queue 1 item 6)")
        KV.paged_write_tokens(cache, k, v, offset, fmt=policy.fmt_kv,
                              packed=policy.kv_packed)
        entry = exec_plan.resolve(
            "paged_decode", policy, batch=B,
            page_size=cache["k_codes"].shape[1],
            max_pages=cache["block_table"].shape[1],
            kv_heads=cfg.n_kv_heads, hd=hd, n_pages=cache["k_codes"].shape[0])
        y = entry.run(q, cache, offset, policy=policy, scale=scale)
        y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd),
                         policy)
        return y, cache
    if cache is not None and "k_codes" in cache:
        # contiguous quantized cache: rows quantize into the format-width
        # cache; attention consumes the dequantized-in-prologue values, so
        # prefill and decode see identical numerics
        KV.update_kv_cache(cache, k, v, offset, fmt=policy.fmt_kv,
                           packed=policy.kv_packed)
        if Sq == 1:
            entry = exec_plan.resolve(
                "decode_attn", policy, batch=B,
                s_ctx=cache["k_codes"].shape[1], kv_heads=cfg.n_kv_heads,
                hd=hd)
            y = entry.run(q, cache, offset, policy=policy, scale=scale)
            y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd),
                             policy)
            return y, cache
        k, v = KV.dequantize_cache(cache, fmt=policy.fmt_kv,
                                   packed=policy.kv_packed)
        kv_on_grid = True
    elif cache is not None:
        off = KV._update_offset(offset, cache["k"].shape[1], Sq)
        cache["k"][:, off:off + Sq] = k.to(cache["k"].dtype)
        cache["v"][:, off:off + Sq] = v.to(cache["v"].dtype)
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    y = _sdpa(q, k, v, causal=True, window=None,
              offset=int(offset) if cache is not None or Sq > 1 else 0,
              policy=policy, kv_on_grid=kv_on_grid)
    y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd), policy)
    return y, cache


# -----------------------------------------------------------------------------
# MLP (SwiGLU)
# -----------------------------------------------------------------------------

def init_mlp(generator, cfg, device="cpu"):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act != "silu":
        raise NotImplementedError("the port's decoder is SwiGLU; GELU MLPs "
                                  "join with their families (ROADMAP Queue "
                                  "1 item 12)")
    return {"wg": init_linear(generator, d, f, device=device),
            "wu": init_linear(generator, d, f, device=device),
            "wd": init_linear(generator, f, d, device=device)}


def apply_mlp(params, x, cfg):
    policy = get_policy(cfg.policy)
    g = apply_linear(params["wg"], x, policy)
    u = apply_linear(params["wu"], x, policy)
    h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return apply_linear(params["wd"], h, policy)


# -----------------------------------------------------------------------------
# embeddings / unembedding
# -----------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d: int, device="cpu"):
    return {"table": torch.randn((vocab, d), generator=generator,
                                 dtype=torch.float32, device=device) * 0.02}


def apply_embedding(params, ids, dtype):
    # gather first, then cast: the same values as casting the table
    return params["table"][ids].to(dtype)


def apply_unembed(x, table):
    """x: (B,S,d) -> f32 logits (B,S,V) over the compute-dtype table."""
    entry = exec_plan.resolve("unembed", None,
                              size=x.shape[-2] * table.shape[0])
    return entry.run(x, table, get_policy("fp32"))
