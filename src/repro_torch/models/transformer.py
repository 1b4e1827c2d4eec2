"""Blocks and the layer stack of every family the port serves (port of
`repro.models.transformer`).

A family is a repeating block pattern (`family_pattern`): decoder, VLM
and MoE ("attn",), RecurrentGemma ("rg", "rg", "attn_local"), xLSTM seven
"mlstm" and one "slstm"; the encoder-decoder has two uniform stacks of
"enc" blocks (non-causal self-attention) and "dec" blocks (causal
self-attention, then cross-attention over the encoder's output
`enc_out`).  Layer l has kind pattern[l % P].  The
reference stacks the first n_layers // P groups of P blocks on a scan
axis (`stack.groups.p0 .. p{P-1}`) and runs the n_layers mod P layers
left as an unscanned tail; the port keeps a plain per-layer list in that
same order (`models.convert` unstacks groups and tail), and caches are a
matching list of per-layer caches.

Remat, as the reference's `jax.checkpoint` around each scanned block,
applies to the cacheless forward while autograd records it (a train
step; a forward-only call runs the blocks as they are):
  remat="full"   each block runs under `torch.utils.checkpoint`; only its
                 input is kept, the block recomputes in backward;
  remat="dots"   the same, but the products' outputs (cuBLAS `mm` /
                 `bmm`, what `checkpoint_dots` saves) are kept through
                 selective checkpointing.  The CPU's plain products are
                 an elementwise product and a sum, not a GEMM, so on the
                 CPU "dots" recomputes as "full" does;
  remat_block=k  two-level remat over "full" or "dots": the stack's input
                 is kept every k blocks and each run of k blocks
                 recomputes under its own checkpoint (sqrt-L memory),
                 when k divides the layers and is below their number.
Recomputation replays the same operations on the same inputs, so every
remat setting gives the same losses and gradients bit for bit.  The
block's aux loss flows through the checkpoint with its output.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.kvcache import init_kv_cache
from repro_torch.core.linear import apply_linear
from repro_torch.core.policy import get_policy

from . import layers as L
from .config import ModelConfig


ATTN_KINDS = ("attn", "attn_local", "enc", "dec")


def family_pattern(cfg: ModelConfig):
    if cfg.family in ("decoder", "vlm", "moe"):
        return ("attn",)
    if cfg.family == "encdec":        # the decoder stack's (`EncDecModel`)
        return ("dec",)
    if cfg.family == "rglru":
        return tuple(cfg.pattern) or ("rg", "rg", "attn_local")
    if cfg.family == "xlstm":
        n = cfg.slstm_every or 8
        return ("mlstm",) * (n - 1) + ("slstm",)
    raise ValueError(cfg.family)


def layer_kinds(cfg: ModelConfig) -> list:
    """Each layer's block kind, in layer order."""
    pattern = family_pattern(cfg)
    return [pattern[i % len(pattern)] for i in range(cfg.n_layers)]


def n_grouped(cfg: ModelConfig) -> int:
    """The layers the reference stacks on its scan axis (the rest are its
    unscanned tail)."""
    P = len(family_pattern(cfg))
    return cfg.n_layers // P * P


def init_block(generator, cfg: ModelConfig, kind: str = "attn",
               device="cpu"):
    d = cfg.d_model
    p = {"norm1": L.init_norm(d, device, cfg.norm)}
    if kind in ATTN_KINDS:
        p["attn"] = L.init_attention(generator, cfg, device)
    elif kind == "rg":
        p["rg"] = L.init_rglru(generator, cfg, device)
    elif kind == "mlstm":
        p["mix"] = L.init_mlstm(generator, cfg, device)
    elif kind == "slstm":
        p["mix"] = L.init_slstm(generator, cfg, device)
    else:
        raise ValueError(kind)
    if kind == "dec":
        p["norm_cross"] = L.init_norm(d, device, cfg.norm)
        p["cross"] = L.init_attention(generator, cfg, device)
    if cfg.d_ff > 0:
        p["norm2"] = L.init_norm(d, device, cfg.norm)
        p["mlp"] = (L.init_moe(generator, cfg, device) if cfg.is_moe
                    else L.init_mlp(generator, cfg, device))
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_ctx: int,
                     dtype, device="cpu"):
    """One layer's decode cache.  A full attention layer's ("attn", or a
    decoder block's "dec" self-attention): the quantized
    layout (codes + per-row scales) when the policy sets fmt_kv, else raw
    compute-dtype K/V.  A local layer's stays raw, (B, min(window, s_ctx),
    KV, hd), under any policy (the shift-left update would roll codes and
    scales together, and the window bounds it already).  RG-LRU: {"h":
    (B, dr) f32, "conv": (B, cw - 1, dr)}; mLSTM (C, n, m); sLSTM (c, n,
    h, m) with m at -10."""
    def zeros(shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    hd, KV = cfg.hd, cfg.n_kv_heads
    if kind in ("attn", "dec"):
        pol = get_policy(cfg.policy)
        if pol.kv_quantized:
            return init_kv_cache(batch, s_ctx, KV, hd, fmt=pol.fmt_kv,
                                 packed=pol.kv_packed, device=device)
        return {"k": zeros((batch, s_ctx, KV, hd), dtype),
                "v": zeros((batch, s_ctx, KV, hd), dtype)}
    if kind == "attn_local":
        w = min(cfg.window or s_ctx, s_ctx)
        return {"k": zeros((batch, w, KV, hd), dtype),
                "v": zeros((batch, w, KV, hd), dtype)}
    if kind == "rg":
        dr = cfg.d_rnn or cfg.d_model
        return {"h": zeros((batch, dr)),
                "conv": zeros((batch, cfg.conv_width - 1, dr), dtype)}
    if kind == "mlstm":
        H = cfg.n_heads
        return (zeros((batch, H, hd, hd)), zeros((batch, H, hd)),
                zeros((batch, H)))
    if kind == "slstm":
        d = cfg.d_model
        return (zeros((batch, d)), zeros((batch, d)), zeros((batch, d)),
                torch.full((batch, d), -10.0, device=device))
    raise ValueError(kind)


def apply_block(params, x, cfg: ModelConfig, kind: str = "attn", *,
                offset=0, cache=None, per_row: bool = False, enc_out=None):
    """-> (x, cache, aux): aux is the MoE load-balancing loss, 0 for a
    dense block.  `per_row`: the verify pass (`layers` module doc).  A
    "dec" block attends over `enc_out` (B, Se, d) after its
    self-attention; the cross keys and values are projected from it at
    every call, as in the reference (no cache holds them)."""
    h = L.apply_norm(params["norm1"], x, eps=cfg.norm_eps, per_row=per_row)
    if kind in ATTN_KINDS:
        local = kind == "attn_local"
        y, cache = L.apply_attention(
            params["attn"], h, cfg, offset=offset, cache=cache,
            per_row=per_row, window=cfg.window if local else None,
            cache_mode="window" if local else "full",
            causal=kind != "enc")
    elif kind == "rg":
        y, cache = L.apply_rglru(params["rg"], h, cfg, state=cache)
    elif kind == "mlstm":
        y, cache = L.apply_mlstm(params["mix"], h, cfg, state=cache)
    elif kind == "slstm":
        y, cache = L.apply_slstm(params["mix"], h, cfg, state=cache)
    else:
        raise ValueError(kind)
    x = x + y.to(x.dtype)
    if kind == "dec":
        pol = get_policy(cfg.policy)
        h = L.apply_norm(params["norm_cross"], x, eps=cfg.norm_eps)
        B, Se = enc_out.shape[:2]
        kv = {name: apply_linear(params["cross"][w], enc_out, pol).reshape(
            B, Se, cfg.n_kv_heads, cfg.hd)
            for name, w in (("k", "wk"), ("v", "wv"))}
        y, _ = L.apply_attention(params["cross"], h, cfg, cross_kv=kv)
        x = x + y.to(x.dtype)
    aux = 0.0
    if cfg.d_ff > 0:
        h = L.apply_norm(params["norm2"], x, eps=cfg.norm_eps,
                         per_row=per_row)
        if cfg.is_moe:
            y, aux = L.apply_moe(params["mlp"], h, cfg, per_row=per_row)
        else:
            y = L.apply_mlp(params["mlp"], h, cfg, per_row=per_row)
        x = x + y.to(x.dtype)
    return x, cache, aux


# the products "dots" keeps: what cuBLAS runs for `rowwise_dot` and
# `batched_rowwise_dot` on the card
_DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.addmm.default)


def _records(x) -> bool:
    """Autograd records x's history (a train step, not a forward-only
    call)."""
    return torch.is_grad_enabled() and x.requires_grad


def _remat(fn, cfg: ModelConfig):
    """fn under the config's checkpoint policy."""
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, list(_DOT_OPS))

    def run(*args):
        return checkpoint(fn, *args, **kw)
    return run


def _block_fn(lp, cfg: ModelConfig, kind: str, enc_out=None):
    """x -> (x, aux) through one cacheless block."""
    def run(x):
        x, _, aux = apply_block(lp, x, cfg, kind, enc_out=enc_out)
        return x, aux
    return run


def _chain(fns):
    """x -> (x, aux summed in f32) through fns, each x -> (x, aux)."""
    def run(x):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for fn in fns:
            x, a = fn(x)
            aux = aux + a
        return x, aux
    return run


def _remat_stack(layers, x, cfg: ModelConfig, kinds, enc_out=None):
    """The cacheless stack under remat (module doc) -> (x, aux)."""
    blocks = [_remat(_block_fn(lp, cfg, kind, enc_out), cfg)
              for lp, kind in zip(layers, kinds)]
    n, k = len(layers), cfg.remat_block
    if k > 1 and n % k == 0 and n > k:
        blocks = [_remat(_chain(blocks[i:i + k]), cfg)
                  for i in range(0, n, k)]
    return _chain(blocks)(x)


def apply_stack(layers, x, cfg: ModelConfig, *, offset=0, caches=None,
                per_row: bool = False, enc_out=None, kinds=None):
    """-> (x, caches, aux summed over the layers in f32); caches None runs
    without state, under the config's remat when autograd records.
    `kinds`: each layer's block kind (default `layer_kinds(cfg)`; the
    encoder-decoder passes its stack's); `enc_out`: the "dec" blocks'
    cross-attention input."""
    kinds = layer_kinds(cfg) if kinds is None else kinds
    if (caches is None and cfg.remat != "none" and _records(x)
            and not per_row):
        x, aux = _remat_stack(layers, x, cfg, kinds, enc_out)
        return x, caches, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (lp, kind) in enumerate(zip(layers, kinds)):
        c = None if caches is None else caches[i]
        x, c, a = apply_block(lp, x, cfg, kind, offset=offset, cache=c,
                              per_row=per_row, enc_out=enc_out)
        aux = aux + a
    return x, caches, aux
