"""Decoder blocks and the layer stack, dense or MoE (port of the decoder
path of `repro.models.transformer`).

The reference stacks per-layer params on a scan axis; the port keeps a
plain per-layer list (`models.convert` unstacks), and caches are a
matching list of per-layer dicts.
"""
from __future__ import annotations

import torch

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


def apply_stack(layers, x, cfg: ModelConfig, *, offset=0, caches=None,
                per_row: bool = False):
    """-> (x, caches, aux summed over the layers in f32); caches None runs
    without state."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(layers):
        c = None if caches is None else caches[i]
        x, c, a = apply_block(lp, x, cfg, offset=offset, cache=c,
                              per_row=per_row)
        aux = aux + a
    return x, caches, aux
