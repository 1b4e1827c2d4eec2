"""Decoder blocks and the layer stack, dense or MoE (port of the decoder
path of `repro.models.transformer`).

The reference stacks per-layer params on a scan axis; the port keeps a
plain per-layer list (`models.convert` unstacks), and caches are a
matching list of per-layer dicts.

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
from repro_torch.core.policy import get_policy

from . import layers as L
from .config import ModelConfig


def init_block(generator, cfg: ModelConfig, device="cpu"):
    d = cfg.d_model
    return {"norm1": L.init_norm(d, device),
            "attn": L.init_attention(generator, cfg, device),
            "norm2": L.init_norm(d, device),
            "mlp": (L.init_moe(generator, cfg, device) if cfg.is_moe
                    else L.init_mlp(generator, cfg, device))}


def init_block_cache(cfg: ModelConfig, batch: int, s_ctx: int, dtype,
                     device="cpu"):
    """One layer's decode cache: the quantized layout (codes + per-row
    scales) when the policy sets fmt_kv, else raw compute-dtype K/V."""
    pol = get_policy(cfg.policy)
    if pol.kv_quantized:
        return init_kv_cache(batch, s_ctx, cfg.n_kv_heads, cfg.hd,
                             fmt=pol.fmt_kv, packed=pol.kv_packed,
                             device=device)
    shp = (batch, s_ctx, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


def apply_block(params, x, cfg: ModelConfig, *, offset=0, cache=None,
                per_row: bool = False):
    """-> (x, cache, aux): aux is the MoE load-balancing loss, 0 for a
    dense block.  `per_row`: the verify pass (`layers` module doc)."""
    h = L.apply_norm(params["norm1"], x, eps=cfg.norm_eps, per_row=per_row)
    y, cache = L.apply_attention(params["attn"], h, cfg, offset=offset,
                                 cache=cache, per_row=per_row)
    x = x + y.to(x.dtype)
    h = L.apply_norm(params["norm2"], x, eps=cfg.norm_eps, per_row=per_row)
    if cfg.is_moe:
        y, aux = L.apply_moe(params["mlp"], h, cfg)
    else:
        y, aux = L.apply_mlp(params["mlp"], h, cfg), 0.0
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


def _block_fn(lp, cfg: ModelConfig):
    """x -> (x, aux) through one cacheless block."""
    def run(x):
        x, _, aux = apply_block(lp, x, cfg)
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


def _remat_stack(layers, x, cfg: ModelConfig):
    """The cacheless stack under remat (module doc) -> (x, aux)."""
    blocks = [_remat(_block_fn(lp, cfg), cfg) for lp in layers]
    n, k = len(layers), cfg.remat_block
    if k > 1 and n % k == 0 and n > k:
        blocks = [_remat(_chain(blocks[i:i + k]), cfg)
                  for i in range(0, n, k)]
    return _chain(blocks)(x)


def apply_stack(layers, x, cfg: ModelConfig, *, offset=0, caches=None,
                per_row: bool = False):
    """-> (x, caches, aux summed over the layers in f32); caches None runs
    without state, under the config's remat when autograd records."""
    if (caches is None and cfg.remat != "none" and _records(x)
            and not per_row):
        x, aux = _remat_stack(layers, x, cfg)
        return x, caches, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(layers):
        c = None if caches is None else caches[i]
        x, c, a = apply_block(lp, x, cfg, offset=offset, cache=c,
                              per_row=per_row)
        aux = aux + a
    return x, caches, aux
