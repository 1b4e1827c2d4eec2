"""Layer library of the port's decoders, dense and MoE (port of the parts
of `repro.models.layers` the serving path runs).

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
from repro_torch.core.linear import (apply_linear, dpa_grouped_dot,
                                     init_grouped_linear, init_linear)
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


def _sdpa(q, k, v, *, causal, window, offset, valid=None, use_flash=False,
          policy=None, kv_on_grid=False):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd), through the
    `flash_attn` route the plan resolves; `use_flash` (the config's) makes
    the flash kernels eligible for a prefill with no extra key mask."""
    policy = get_policy(policy if policy is not None else "fp32")
    entry = exec_plan.resolve("flash_attn", policy, sq=q.shape[1],
                              skv=k.shape[1], use_flash=use_flash,
                              has_valid=valid is not None,
                              kv_on_grid=kv_on_grid)
    return entry.run(q, k, v, policy=policy, causal=causal, window=window,
                     offset=offset, valid=valid, scale=q.shape[-1] ** -0.5,
                     kv_on_grid=kv_on_grid)


def _positions(offset, B, Sq, device):
    """(B, Sq) per-request positions for a (B,) offset vector, else the
    (Sq,) positions after a scalar offset (an int or a 0-dim tensor)."""
    steps = torch.arange(Sq, device=device)
    if not torch.is_tensor(offset):
        return int(offset) + steps
    offset = offset.to(device=device, dtype=torch.int64)
    return offset[:, None] + steps[None] if offset.ndim == 1 else \
        offset + steps


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
                "pass (ROADMAP Queue 1, \"Speculative decoding and the "
                "adaptive draft ladder\")")
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
        KV.write_rows(cache["k"], k.to(cache["k"].dtype), offset)
        KV.write_rows(cache["v"], v.to(cache["v"].dtype), offset)
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    # a tensor offset passes through (the plain routes mask with it; the
    # CUDA flash routes only ever see a cacheless prefill at offset 0)
    if cache is None and Sq == 1:
        offset = 0
    elif not torch.is_tensor(offset):
        offset = int(offset)
    y = _sdpa(q, k, v, causal=True, window=None, offset=offset,
              use_flash=cfg.use_flash, policy=policy, kv_on_grid=kv_on_grid)
    y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd), policy)
    return y, cache


# -----------------------------------------------------------------------------
# MLP (SwiGLU)
# -----------------------------------------------------------------------------

def init_mlp(generator, cfg, device="cpu"):
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act != "silu":
        raise NotImplementedError("the port's decoder is SwiGLU; GELU MLPs "
                                  "are ROADMAP Queue 1, \"Decoder "
                                  "breadth\"")
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
# MoE: top-k routing with sort-based capacity dispatch
# -----------------------------------------------------------------------------

def init_moe(generator, cfg, device="cpu"):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    if cfg.act != "silu":
        raise NotImplementedError("the port's MoE experts are SwiGLU; GELU "
                                  "experts are ROADMAP Queue 1, \"Decoder "
                                  "breadth\"")
    return {"router": init_linear(generator, d, E, device=device),
            "wg": init_grouped_linear(generator, E, d, f, device=device),
            "wu": init_grouped_linear(generator, E, d, f, device=device),
            "wd": init_grouped_linear(generator, E, f, d, device=device)}


def _softmax(x):
    """jax.nn.softmax's formula: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def apply_moe(params, x, cfg):
    """x: (B, S, d) -> (y, aux_loss).

    Group-local dispatch, as in the reference: each batch row routes its
    own S tokens into an (E, C, d) buffer, C = int(cf * S * K / E) + 1,
    and the reference's vmap over rows is the leading batch dim here.
    Assignments sort by expert (stably, so a row's tokens keep their
    order within an expert); an assignment past its expert's capacity is
    dropped, and still scatter-adds a zero into slot 0.  The combine sums
    each token's weighted expert outputs in x's dtype in the reference's
    scatter order — ascending expert — one add at a time, so it is
    deterministic on the card (no atomics)."""
    policy = get_policy(cfg.policy)
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = int(cfg.capacity_factor * S * K / E) + 1
    dev = x.device

    logits = apply_linear(params["router"], x.to(torch.float32), "fp32")
    probs = _softmax(logits)                                     # (B, S, E)
    # lax.top_k: descending, ties to the lower index — a stable sort
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = top.values[..., :K], top.indices[..., :K]  # (B, S, K)
    gate_w = gate_w / torch.clamp_min(gate_w.sum(-1, keepdim=True), 1e-9)

    # aux load-balancing loss (Switch style); a mean is a sum times
    # f32(1/n), as the jitted reference computes it
    inv_n = recip(B * S)
    density = torch.nn.functional.one_hot(gate_i[..., 0], E).to(
        torch.float32).sum((0, 1)) * inv_n
    density_prob = probs.sum((0, 1)) * inv_n
    aux = (density * density_prob).sum() * E * cfg.router_aux_coef

    # dispatch: (B, S*K) assignments sorted by expert, positions within
    # each expert's capacity
    flat_e = gate_i.reshape(B, S * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(1, order)
    counts = torch.nn.functional.one_hot(flat_e, E).sum(1)      # (B, E)
    start = counts.cumsum(1) - counts
    pos = torch.arange(S * K, device=dev) - start.gather(1, sorted_e)
    keep = pos < C
    pos_c = torch.where(keep, pos, 0)
    rows = torch.arange(B, device=dev)[:, None].expand(B, S * K)
    xt = x.gather(1, (order // K)[..., None].expand(B, S * K, d))
    buf = torch.zeros((B, E, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((rows, sorted_e, pos_c),
                   torch.where(keep[..., None], xt, 0).to(x.dtype),
                   accumulate=True)

    def expert_mm(name, z):
        return dpa_grouped_dot(z, params[name], policy, eq="becd,edf->becf")

    h = torch.nn.functional.silu(expert_mm("wg", buf).to(torch.float32)
                                 ).to(x.dtype) * expert_mm("wu", buf)
    out_buf = expert_mm("wd", h)                                 # (B,E,C,d)

    # combine, per assignment in (token, slot) order: its expert's output
    # row (zero when dropped) times its gate weight, rounded to x's dtype
    inv = torch.argsort(order, dim=-1)
    keep_f, pos_f = keep.gather(1, inv), pos_c.gather(1, inv)
    g = torch.where(keep_f[..., None], out_buf[rows, flat_e, pos_f], 0)
    contrib = (g.to(torch.float32) * gate_w.reshape(B, S * K, 1)).to(
        x.dtype).reshape(B, S, K, d)
    by_expert = torch.argsort(gate_i, dim=-1)     # a token's experts differ
    contrib = contrib.gather(2, by_expert[..., None].expand(B, S, K, d))
    y = torch.zeros((B, S, d), dtype=x.dtype, device=dev)
    for j in range(K):
        y = y + contrib[:, :, j]
    return y, aux


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
