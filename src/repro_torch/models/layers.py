"""Layer library of the port: RMSNorm and LayerNorm, attention (full,
sliding-window, non-causal and cross), the SwiGLU and GELU MLPs, MoE,
the RG-LRU block (RecurrentGemma) and the mLSTM and sLSTM blocks (xLSTM)
(port of `repro.models.layers`).

Every projection goes through `core.linear.apply_linear` (the DPA
contract) and every attention/unembed through an `exec_plan` route, so
this module carries no policy-mode branching.  Layers are functions over
a params dict; decode paths carry explicit caches and recurrent states,
updated in place (`copy_` into their own storage, so a captured step's
CUDA graph replays the writes).

The speculative verify pass (S_q query tokens a request over the paged
cache) must give each query row the decode step's bits.  On the CPU
every plain path treats rows alike.  On the card two reductions pick
their order by the number of rows, as chip_smoke.py's probe of a verify
pass against stepped decode steps finds them on an H100: RMSNorm's sum
of squares (ATen's reduce kernel lays its threads out by the number of
outputs; the block norms, qk-norm and the final norm) and the tied
unembed (cuBLAS picks its GEMM by M).  With `per_row` each runs there as
S_q calls at the decode step's shape.  The fused matmul (below
`TILED_MIN_M` rows), rope and the attention kernel give every row the
decode step's bits as they stand.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import exec_plan
from repro_torch.core import kvcache as KV
from repro_torch.core.linear import (apply_linear, dpa_grouped_dot,
                                     init_grouped_linear, init_linear)
from repro_torch.core.policy import get_policy
from repro_torch.core.quantize import recip
from repro_torch.distributed import tp as TP

# -----------------------------------------------------------------------------
# norms
# -----------------------------------------------------------------------------


def _rows_apart(x, per_row: bool) -> bool:
    """The verify pass on the card (x (B, S_q, ...), S_q > 1): run one
    query row at a time (module doc)."""
    return per_row and x.device.type == "cuda" and x.shape[1] > 1


def init_norm(d: int, device="cpu", kind: str = "rmsnorm"):
    """Unit scale; a LayerNorm ("layernorm") also has a zero bias."""
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def _row_sums(t, per_row: bool):
    """Sums over the last dim, keepdim; `per_row`: each query row's on its
    contiguous (B, 1, ...) slice, the decode step's shape (module doc)."""
    if _rows_apart(t, per_row):
        return torch.cat([t[:, i:i + 1].contiguous().sum(dim=-1, keepdim=True)
                          for i in range(t.shape[1])], dim=1)
    return t.sum(dim=-1, keepdim=True)


def apply_norm(params, x, *, eps: float = 1e-5, per_row: bool = False):
    """RMSNorm, or LayerNorm when the params carry a bias, in f32; a mean
    (LayerNorm's variance too) is a sum times f32(1/d), as the jitted
    reference computes it.  `per_row`: the verify pass (module doc): the
    sums run on each query row's contiguous (B, 1, ...) slice; the
    elementwise rest treats rows alike."""
    xf = x.to(torch.float32)
    inv_d = recip(xf.shape[-1])
    if "bias" in params:
        c = xf - _row_sums(xf, per_row) * inv_d
        var = _row_sums(c * c, per_row) * inv_d
        y = c * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:
        ms = _row_sums(xf * xf, per_row) * inv_d
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
    bias = cfg.qkv_bias
    p = {
        "wq": init_linear(generator, d, cfg.n_heads * hd, bias=bias,
                          device=device),
        "wk": init_linear(generator, d, cfg.n_kv_heads * hd, bias=bias,
                          device=device),
        "wv": init_linear(generator, d, cfg.n_kv_heads * hd, bias=bias,
                          device=device),
        "wo": init_linear(generator, cfg.n_heads * hd, d, device=device),
    }
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, device)
        p["k_norm"] = init_norm(hd, device)
    return p


def _sdpa(q, k, v, *, causal, window, offset, valid=None, use_flash=False,
          q_chunk=0, policy=None, kv_on_grid=False):
    """q: (B,Sq,H,hd); k/v: (B,Skv,KV,hd) -> (B,Sq,H,hd), through the
    `flash_attn` route the plan resolves; `use_flash` (the config's) makes
    the flash kernels eligible for a prefill with no extra key mask.

    q_chunk (the config's `attn_chunk`): on a plain route, as in the
    reference, query blocks of q_chunk rows run one after another, so the
    (Sq, Skv) logits never exist whole, when q_chunk divides Sq, is below
    it and there is no key mask.  While autograd records, each block runs
    under a checkpoint: its (q_chunk, Skv) logits are recomputed in
    backward instead of kept.  The config's attn_chunk holds on every
    plain-route call, serving's plain prefill and the use_flash-off
    scoring pass included.  On the CPU every query row reduces alone on
    the plain routes, so the output equals the unchunked one bit for bit;
    on the card the products are cuBLAS GEMMs, which pick their kernel by
    shape, so a block's rows may differ from the unchunked ones in the
    last bits.  The gradients of K and V sum the blocks' parts in another
    order."""
    B, Sq, H, hd = q.shape
    policy = get_policy(policy if policy is not None else "fp32")
    entry = exec_plan.resolve("flash_attn", policy, sq=Sq,
                              skv=k.shape[1], hd=hd, use_flash=use_flash,
                              has_valid=valid is not None,
                              kv_on_grid=kv_on_grid)
    if (entry.backend != "cuda" and q_chunk and Sq > q_chunk
            and Sq % q_chunk == 0 and valid is None):
        def chunk(qs, i):
            return _sdpa(qs, k, v, causal=causal, window=window,
                         offset=offset + i * q_chunk, policy=policy,
                         kv_on_grid=kv_on_grid)
        outs = []
        for i in range(Sq // q_chunk):
            qs = q[:, i * q_chunk:(i + 1) * q_chunk]
            outs.append(checkpoint(chunk, qs, i, use_reentrant=False,
                                   preserve_rng_state=False)
                        if torch.is_grad_enabled() and q.requires_grad
                        else chunk(qs, i))
        return torch.cat(outs, dim=1)
    return entry.run(q, k, v, policy=policy, causal=causal, window=window,
                     offset=offset, valid=valid, scale=hd ** -0.5,
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


def window_valid(offset, W: int, device):
    """(W,) bool: the filled slots of a sliding-window cache after the
    decode step at `offset` (an int or a 0-dim tensor): slot s holds
    position offset - (W - 1 - s), valid iff >= 0."""
    filled = (torch.clamp(offset + 1, max=W) if torch.is_tensor(offset)
              else min(int(offset) + 1, W))
    return torch.arange(W, device=device) >= W - filled


def _window_append(dst, new):
    """Shift the (B, W, ...) window left by one and append new (B, 1,
    ...), in dst's own storage."""
    dst.copy_(torch.cat([dst[:, 1:], new.to(dst.dtype)], dim=1))


def _window_fill(dst, new):
    """A prefill's last W rows of new (B, S, ...) into the (B, W, ...)
    window in time order, left-padded with zeros when S < W (in place)."""
    W = dst.shape[1]
    pad = max(0, W - new.shape[1])
    dst[:, :pad] = 0
    dst[:, pad:] = new[:, -W:].to(dst.dtype)


def apply_attention(params, x, cfg, *, offset=0, cache=None,
                    per_row: bool = False, window=None,
                    cache_mode: str = "full", cross_kv=None,
                    causal: bool = True):
    """Returns (y, cache).  Cache layouts: the paged quantized pool (with
    "block_table"; `offset` a (B,) position vector), the contiguous
    quantized cache ("k_codes"), the raw full cache ("k"), or none.
    `window`: a local attention width (masks keys at or past it).
    `cache_mode` "window": the raw (B, W, KV, hd) cache of a local layer,
    kept in time order: decode shifts it left and appends the new row,
    attending over the whole cache (not causal, offset 0) with its
    unfilled leading slots masked (`window_valid`); prefill keeps its
    last W rows, left-padded with zeros.  `per_row`: the verify pass
    (module doc).
    `cross_kv` {"k", "v": (B, Se, KV, hd)}: cross-attention over those
    keys and values (the encoder's, projected by the caller): no K/V
    projection, no k-norm, no rope, no cache, not causal.  `causal`
    False: every query sees every key (the encoder).  Rope on q and k
    when the config has a rope theta and the keys are the layer's own."""
    policy = get_policy(cfg.policy)
    B, Sq, _ = x.shape
    hd = cfg.hd
    q = apply_linear(params["wq"], x, policy).reshape(B, Sq, cfg.n_heads, hd)
    if cross_kv is not None:
        k, v, cache = cross_kv["k"], cross_kv["v"], None
    else:
        k = apply_linear(params["wk"], x, policy).reshape(
            B, Sq, cfg.n_kv_heads, hd)
        v = apply_linear(params["wv"], x, policy).reshape(
            B, Sq, cfg.n_kv_heads, hd)
    if "q_norm" in params:
        q = apply_norm(params["q_norm"], q, eps=cfg.norm_eps,
                       per_row=per_row)
        if cross_kv is None:
            k = apply_norm(params["k_norm"], k, eps=cfg.norm_eps,
                           per_row=per_row)
    if cross_kv is None and cfg.rope_theta > 0:
        pos = _positions(offset, B, Sq, x.device)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)

    scale = hd ** -0.5
    kv_on_grid = False
    if cache is not None and "seq_shard" in cache:
        # a raw cache sequence-sharded over the active TP group
        # (`distributed.sharding.shard_seq_caches`, which shards only
        # where the sequence divides): flash decoding's partial-softmax
        # combine.  An unsharded cache, or no group, takes the plain path
        if not (cfg.flash_decode and Sq == 1 and cross_kv is None
                and cache_mode == "full"):
            raise NotImplementedError(
                "a sequence-sharded cache serves flash_decode's single-token "
                f"decode steps only (flash_decode={cfg.flash_decode}, "
                f"S_q={Sq}, cache_mode={cache_mode!r})")
        from repro_torch.models.decode_attn import flash_decode
        y = flash_decode(q, k, v, cache["k"], cache["v"], offset,
                         TP.require_group(), scale=scale)
        y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd),
                         policy)
        return y, cache
    if cache is not None and "block_table" in cache:
        # the continuous-batching engine's paged pool: new tokens quantize
        # into each request's pages, attention reads codes through the
        # block table.  Sq == 1 is the decode step; Sq > 1 the speculative
        # verify window (the last accepted token and the drafts), scored
        # with per-request causal masks through the verify_attn route
        # (prefill runs against the contiguous staging cache)
        # under a TP group (`distributed.tp`) the pool holds this rank's
        # rows of every page and the sharded routes gather it
        shard = TP.shard()
        KV.paged_write_tokens(cache, k, v, offset, fmt=policy.fmt_kv,
                              packed=policy.kv_packed, shard=shard)
        ctx = dict(batch=B, page_size=cache["k_codes"].shape[1] * shard[1],
                   max_pages=cache["block_table"].shape[1],
                   kv_heads=cfg.n_kv_heads, hd=hd,
                   n_pages=cache["k_codes"].shape[0], n_devices=shard[1])
        entry = (exec_plan.resolve("paged_decode", policy, **ctx) if Sq == 1
                 else exec_plan.resolve("verify_attn", policy, sq=Sq, **ctx))
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
    causal = causal and cross_kv is None
    valid = None
    if cache is not None and cache_mode == "window":
        if Sq == 1:
            _window_append(cache["k"], k)
            _window_append(cache["v"], v)
            valid = window_valid(offset, cache["k"].shape[1], x.device)
            k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
            causal, window, offset = False, None, 0
        else:
            _window_fill(cache["k"], k)
            _window_fill(cache["v"], v)
    elif cache is not None and not kv_on_grid:
        KV.write_rows(cache["k"], k.to(cache["k"].dtype), offset)
        KV.write_rows(cache["v"], v.to(cache["v"].dtype), offset)
        k, v = cache["k"].to(x.dtype), cache["v"].to(x.dtype)
    # a tensor offset passes through (the plain routes mask with it; the
    # CUDA flash routes only ever see a prefill at offset 0)
    if cache is None and Sq == 1:
        offset = 0
    elif not torch.is_tensor(offset):
        offset = int(offset)
    y = _sdpa(q, k, v, causal=causal, window=window, offset=offset,
              valid=valid, use_flash=cfg.use_flash, q_chunk=cfg.attn_chunk,
              policy=policy, kv_on_grid=kv_on_grid)
    y = apply_linear(params["wo"], y.reshape(B, Sq, cfg.n_heads * hd), policy)
    return y, cache


# -----------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# -----------------------------------------------------------------------------

def gelu(x):
    """jax.nn.gelu's default, the tanh approximation."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def init_mlp(generator, cfg, device="cpu"):
    """SwiGLU (act "silu"): wg, wu, wd; GELU: wu and wd, with biases."""
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "silu":
        return {"wg": init_linear(generator, d, f, device=device),
                "wu": init_linear(generator, d, f, device=device),
                "wd": init_linear(generator, f, d, device=device)}
    return {"wu": init_linear(generator, d, f, bias=True, device=device),
            "wd": init_linear(generator, f, d, bias=True, device=device)}


def apply_mlp(params, x, cfg):
    policy = get_policy(cfg.policy)
    if "wg" in params:
        g = apply_linear(params["wg"], x, policy)
        u = apply_linear(params["wu"], x, policy)
        h = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    else:
        u = apply_linear(params["wu"], x, policy)
        h = gelu(u.to(torch.float32)).to(x.dtype)
    return apply_linear(params["wd"], h, policy)


# -----------------------------------------------------------------------------
# MoE: top-k routing with sort-based capacity dispatch
# -----------------------------------------------------------------------------

def init_moe(generator, cfg, device="cpu"):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": init_linear(generator, d, E, device=device)}
    if cfg.act == "silu":
        p["wg"] = init_grouped_linear(generator, E, d, f, device=device)
    p["wu"] = init_grouped_linear(generator, E, d, f, device=device)
    p["wd"] = init_grouped_linear(generator, E, f, d, device=device)
    return p


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
    # each token repeated K times, then permuted: the gather's backward
    # writes every slot once, and the K copies' gradients meet in the
    # expand's sum, not in atomic adds
    xk = x[:, :, None].expand(B, S, K, d).reshape(B, S * K, d)
    xt = xk.gather(1, order[..., None].expand(B, S * K, d))
    buf = torch.zeros((B, E, C, d), dtype=x.dtype, device=dev)
    buf.index_put_((rows, sorted_e, pos_c),
                   torch.where(keep[..., None], xt, 0).to(x.dtype),
                   accumulate=True)

    def expert_mm(name, z):
        return dpa_grouped_dot(z, params[name], policy, eq="becd,edf->becf")

    if "wg" in params:
        h = torch.nn.functional.silu(expert_mm("wg", buf).to(torch.float32)
                                     ).to(x.dtype) * expert_mm("wu", buf)
    else:
        h = gelu(expert_mm("wu", buf).to(torch.float32)).to(x.dtype)
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
# elementwise functions in the reference's formulas
# -----------------------------------------------------------------------------

def softplus(x):
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """jax.nn.log_sigmoid: -softplus(-x)."""
    return -softplus(-x)


def _set_state(state, new):
    """Write a recurrent state's new values into its own tensors (in
    place) and return it; a None state (no cache kept) returns new."""
    if state is None:
        return new
    if isinstance(state, dict):
        for key in state:
            state[key].copy_(new[key])
    else:
        for dst, src in zip(state, new):
            dst.copy_(src)
    return state


# -----------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# -----------------------------------------------------------------------------

_RG_C = 8.0


def init_rglru(generator, cfg, device="cpu"):
    d = cfg.d_model
    dr = cfg.d_rnn or d
    cw = cfg.conv_width
    # Lambda such that a = exp(-c softplus(lam) sigmoid(r)) starts near
    # 0.9 .. 0.999 (softplus^-1 of a linspace)
    lam = torch.log(torch.expm1(torch.linspace(0.9, 4.0, dr,
                                               dtype=torch.float64)))
    return {
        "wx": init_linear(generator, d, dr, device=device),
        "wgate": init_linear(generator, d, dr, device=device),
        "conv": torch.randn((cw, dr), generator=generator,
                            dtype=torch.float32, device=device)
        * (cw * dr) ** -0.5,
        "w_ig": init_linear(generator, d, dr, device=device),
        "lam": lam.to(device=device, dtype=torch.float32),
        "wo": init_linear(generator, dr, d, device=device),
    }


def _rglru_coeffs(params, x, policy):
    """-> (a, bx) with h_t = a_t * h_{t-1} + bx_t, all (B, S, dr) f32."""
    xb = apply_linear(params["wx"], x, policy)
    gate = apply_linear(params["wgate"], x, policy).to(torch.float32)
    igate = apply_linear(params["w_ig"], x, policy).to(torch.float32)
    log_a = -_RG_C * softplus(params["lam"]) * torch.sigmoid(gate)
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    bx = mult * torch.sigmoid(igate) * xb.to(torch.float32)
    return a, bx


def conv1d(x, w, state=None):
    """Causal depthwise conv: x (B, S, dr), w (cw, dr), state (B, cw - 1,
    dr) the previous inputs (zeros when None) -> (out in x's dtype, the
    new state: the last cw - 1 inputs).  The taps' products are summed in
    the reference's order, tap 0 first."""
    cw, S = w.shape[0], x.shape[1]
    pad = (torch.zeros(x.shape[:1] + (cw - 1,) + x.shape[2:], dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, :S] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * w[i]
    return out.to(x.dtype), xp[:, S:]


def _combine(c1, c2):
    """The RG-LRU scan's operator: (a2, b2) o (a1, b1) = (a1 a2, a2 b1 +
    b2), c1 the earlier element."""
    return c1[0] * c2[0], c2[0] * c1[1] + c2[1]


def _interleave(even, odd):
    """even[0], odd[0], even[1], ... along axis 1."""
    shape = (even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:]
    out = torch.empty(shape, dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def associative_scan(a, b):
    """Inclusive scan of (a, b) (B, S, ...) along axis 1 under `_combine`,
    in `jax.lax.associative_scan`'s own combine tree (its odd/even
    recursion): adjacent pairs combine, the half-length scan recurses, the
    even elements combine with the scanned odd ones, and the two
    interleave, so every sum comes in the reference's order, in
    2 log2(S) levels."""
    n = a.shape[1]
    if n < 2:
        return a, b
    oa, ob = associative_scan(*_combine((a[:, 0:n - 1:2], b[:, 0:n - 1:2]),
                                        (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        ea, eb = _combine((oa[:, :-1], ob[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        ea, eb = _combine((oa, ob), (a[:, 2::2], b[:, 2::2]))
    return (_interleave(torch.cat([a[:, :1], ea], dim=1), oa),
            _interleave(torch.cat([b[:, :1], eb], dim=1), ob))


def apply_rglru(params, x, cfg, *, state=None):
    """x: (B, S, d) -> (y, state).  state {"h": (B, dr) f32, "conv": (B,
    cw - 1, dr)} is updated in place; None keeps none (training).  A
    one-token step with a state is h = a h0 + bx; otherwise h0 (when
    given) folds into the first bx and the sequence runs the scan."""
    policy = get_policy(cfg.policy)
    xc, conv_state = conv1d(x, params["conv"],
                            None if state is None else state["conv"])
    a, bx = _rglru_coeffs(params, xc, policy)
    h0 = None if state is None else state["h"]
    if x.shape[1] == 1 and h0 is not None:        # decode step
        h = a[:, 0] * h0 + bx[:, 0]
        hs = h[:, None]
    else:
        if h0 is not None:
            bx = torch.cat([bx[:, :1] + a[:, :1] * h0[:, None], bx[:, 1:]],
                           dim=1)
        _, hs = associative_scan(a, bx)
        h = hs[:, -1]
    y = apply_linear(params["wo"], hs.to(x.dtype), policy)
    return y, _set_state(state, {"h": h, "conv": conv_state})


# -----------------------------------------------------------------------------
# xLSTM: chunkwise-parallel mLSTM + sequential sLSTM
# -----------------------------------------------------------------------------

def init_mlstm(generator, cfg, device="cpu"):
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    return {
        "wq": init_linear(generator, d, H * hd, device=device),
        "wk": init_linear(generator, d, H * hd, device=device),
        "wv": init_linear(generator, d, H * hd, device=device),
        "wi": init_linear(generator, d, H, device=device),   # input gate
        "wf": init_linear(generator, d, H, device=device),   # forget gate
        "wo_gate": init_linear(generator, d, H * hd, device=device),
        "wo": init_linear(generator, H * hd, d, device=device),
    }


def _mlstm_chunk(carry, qc, kc, vc, lf, li, hd_scale):
    """One chunk of the stabilized chunkwise mLSTM (the reference's scan
    body).  qc/kc/vc: (B, Ck, H, hd) f32; lf/li: (B, Ck, H); carry (C0
    (B, H, hd, hd), n0 (B, H, hd), m0 (B, H)) -> (h (B, Ck, H, hd), carry
    at the chunk's end)."""
    C0, n0, m0 = carry
    Ck = qc.shape[1]
    cum_f = torch.cumsum(lf, dim=1)                          # (B, Ck, H)
    # intra-chunk decay D[t, s] = exp(cum_f_t - cum_f_s + li_s), s <= t
    lD = cum_f[:, :, None] - cum_f[:, None, :] + li[:, None, :, :]
    tri = torch.tril(torch.ones((Ck, Ck), dtype=torch.bool,
                                device=qc.device))
    lD = torch.where(tri[None, :, :, None], lD, -torch.inf)
    # the inter-chunk contribution decays from m0
    l_inter = cum_f + m0[:, None, :]
    m_t = torch.maximum(lD.amax(dim=2), l_inter)             # (B, Ck, H)
    D = torch.exp(lD - m_t[:, :, None])
    scores = torch.einsum("bthd,bshd->btsh", qc, kc) * hd_scale
    w_ts = scores * D
    h_num = torch.einsum("btsh,bshd->bthd", w_ts, vc)
    h_den = w_ts.sum(dim=2)
    fac = torch.exp(l_inter - m_t)
    q_eff = qc * fac[..., None] * hd_scale
    h_num = h_num + torch.einsum("bthd,bhde->bthe", q_eff, C0)
    h_den = h_den + torch.einsum("bthd,bhd->bth", q_eff, n0)
    floor = torch.exp(torch.clamp(-m_t, -60.0, 60.0))
    h = h_num / torch.maximum(h_den.abs(), floor)[..., None]
    # the state at the chunk's end: decay(s -> end) = exp(f_sum - cum_f_s)
    f_sum = cum_f[:, -1]                                     # (B, H)
    m_next = torch.maximum(f_sum + m0,
                           f_sum + (li - cum_f).amax(dim=1))
    k_dec = torch.exp(f_sum[:, None] - cum_f + li - m_next[:, None])
    decay = torch.exp(f_sum + m0 - m_next)
    C1 = C0 * decay[..., None, None] + torch.einsum(
        "bshd,bshe->bhde", k_dec[..., None] * kc, vc)
    n1 = n0 * decay[..., None] + torch.einsum("bsh,bshd->bhd", k_dec, kc)
    return h, (C1, n1, m_next)


def apply_mlstm(params, x, cfg, *, state=None):
    """x: (B, S, d) -> (y, state); state (C, n, m) is updated in place,
    None keeps none.  The sequence runs in chunks of min(chunk, S), which
    must divide S."""
    policy = get_policy(cfg.policy)
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    f32 = torch.float32
    q = apply_linear(params["wq"], x, policy).reshape(B, S, H, hd)
    k = apply_linear(params["wk"], x, policy).reshape(B, S, H, hd)
    v = apply_linear(params["wv"], x, policy).reshape(B, S, H, hd)
    li = apply_linear(params["wi"], x, policy).to(f32)        # (B, S, H)
    lf = log_sigmoid(apply_linear(params["wf"], x, policy).to(f32))
    og = torch.sigmoid(apply_linear(params["wo_gate"], x, policy).to(f32))
    carry = state if state is not None else (
        torch.zeros((B, H, hd, hd), dtype=f32, device=x.device),
        torch.zeros((B, H, hd), dtype=f32, device=x.device),
        torch.zeros((B, H), dtype=f32, device=x.device))
    Ck = min(cfg.chunk, S)
    if S % Ck:
        raise ValueError(f"mLSTM chunk {Ck} must divide the sequence {S}")
    hs = []
    for c in range(S // Ck):
        sl = slice(c * Ck, (c + 1) * Ck)
        h, carry = _mlstm_chunk(carry, q[:, sl].to(f32), k[:, sl].to(f32),
                                v[:, sl].to(f32), lf[:, sl], li[:, sl],
                                hd ** -0.5)
        hs.append(h)
    h = torch.cat(hs, dim=1) * og.reshape(B, S, H, hd)
    y = apply_linear(params["wo"], h.reshape(B, S, H * hd).to(x.dtype),
                     policy)
    return y, _set_state(state, carry)


def init_slstm(generator, cfg, device="cpu"):
    d = cfg.d_model
    p = {name: init_linear(generator, d, d, device=device)
         for name in ("wz", "wi", "wf", "wo_gate")}
    p["r"] = torch.randn((4, d), generator=generator, dtype=torch.float32,
                         device=device) * d ** -0.5
    p["wo"] = init_linear(generator, d, d, device=device)
    return p


def apply_slstm(params, x, cfg, *, state=None):
    """Sequential sLSTM with diagonal recurrent weights (per-channel r).
    x: (B, S, d) -> (y, state); state (c, n, h, m), each (B, d) f32, is
    updated in place (None keeps none; m starts at -10)."""
    policy = get_policy(cfg.policy)
    B, S, d = x.shape
    f32 = torch.float32
    zx = apply_linear(params["wz"], x, policy).to(f32)
    ix = apply_linear(params["wi"], x, policy).to(f32)
    fx = apply_linear(params["wf"], x, policy).to(f32)
    ox = apply_linear(params["wo_gate"], x, policy).to(f32)
    r = params["r"]
    if state is None:
        z0 = torch.zeros((B, d), dtype=f32, device=x.device)
        c, n, h, m = z0, z0, z0, z0 - 10.0
    else:
        c, n, h, m = state
    hs = []
    for t in range(S):
        z = torch.tanh(zx[:, t] + r[0] * h)
        li = ix[:, t] + r[1] * h
        lf = log_sigmoid(fx[:, t] + r[2] * h)
        m1 = torch.maximum(lf + m, li)
        i_s = torch.exp(li - m1)
        f_s = torch.exp(lf + m - m1)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        h = torch.sigmoid(ox[:, t] + r[3] * h) * c / torch.clamp_min(n, 1e-6)
        m = m1
        hs.append(h)
    y = apply_linear(params["wo"], torch.stack(hs, dim=1).to(x.dtype),
                     policy)
    return y, _set_state(state, (c, n, h, m))


# -----------------------------------------------------------------------------
# embeddings / unembedding
# -----------------------------------------------------------------------------

def init_embedding(generator, vocab: int, d: int, device="cpu"):
    return {"table": torch.randn((vocab, d), generator=generator,
                                 dtype=torch.float32, device=device) * 0.02}


def apply_embedding(params, ids, dtype):
    """Gather first, then cast: the same values as casting the table.
    `embedding`'s backward sums a repeated id's rows without atomics
    (sorted segments on the card), so its gradient is deterministic."""
    return torch.nn.functional.embedding(ids, params["table"]).to(dtype)


def apply_unembed(x, table, *, per_row: bool = False):
    """x: (B,S,d) -> f32 logits (B,S,V) over the compute-dtype table.
    `per_row`: the verify pass (module doc)."""
    entry = exec_plan.resolve("unembed", None,
                              size=x.shape[-2] * table.shape[0])
    return entry.run(x, table, get_policy("fp32"),
                     per_row=_rows_apart(x, per_row))
