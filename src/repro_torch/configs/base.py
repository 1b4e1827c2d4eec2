"""Config registry of the port: the decoder and MoE configurations it
serves, and `reduce_config`, the CPU smoke variant of the same family
(port of `repro.configs.base`; the other families join with their
slices)."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "llama3.2-3b": "llama32_3b",
    "granite-moe-1b-a400m": "granite_moe_1b",
}


def get_config(name: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    return mod.CONFIG


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family smoke config: tiny dims, identical structure/flags."""
    pat = len(cfg.pattern) if cfg.pattern else \
        (cfg.slstm_every if cfg.family == "xlstm" else 1)
    n_layers = max(2, min(cfg.n_layers, pat + 1)) if pat > 1 else 2
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv * 2, 4) if cfg.n_kv_heads > 1 else 4
    return cfg.replace(
        n_layers=n_layers,
        d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 8) if cfg.is_moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.is_moe else 0,
        d_rnn=64 if cfg.d_rnn else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
        chunk=8,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        max_seq=4096,
        dtype="float32", remat="none",
    )
