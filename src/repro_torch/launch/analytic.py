"""Analytic per-cell cost census: FLOPs and HBM bytes per device (the
port's copy of `repro.launch.analytic`).

The FLOP census is derived from the config, so it counts the same work
whatever implements it: remat recompute, attention quadratics, MoE
capacity overhead — everything the 6ND MODEL_FLOPS misses, so the
MODEL / analytic ratio stays meaningful.

It counts the reference's contract, not the bytes that the port's
kernels move: serving weights are counted at the compute dtype unless
`serve_quant` is set, although the port's fused kernels read packed-fp4
codes.  `kernels.census` counts what each launch of the port reads and
writes.

Wire model (per device, `cell_wire_bytes_per_device`): the port's
tensor-parallel collectives.  A decode step all-gathers every full
attention layer's KV pool at format width (codes + per-row f32 scales,
`kernels.census.pool_gather_work`) under a kv-quantized policy, or,
over raw caches, sums flash decoding's partial softmax (max,
denominator and numerator, f32) over the ranks.  Weights are replicated
and prefill is a single-rank reduction, so train and prefill cells move
nothing on the wire.

Byte model (per device):
  train   = opt traffic (params+m+v read&write, f32) + weight fwd/bwd
            reads + activation stores/loads per layer
  prefill = weight reads + activation traffic
  decode  = weight reads + FULL KV-cache read (the decode roofline) +
            cache write + small activations
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def _attn_macs_per_token(cfg: ModelConfig, s_ctx: float, *, decode=False):
    hd = cfg.hd
    proj = cfg.d_model * hd * (cfg.n_heads + 2 * cfg.n_kv_heads) \
        + cfg.n_heads * hd * cfg.d_model
    kv_len = s_ctx if decode else s_ctx / 2.0        # causal average
    scores = 2.0 * cfg.n_heads * hd * kv_len
    return proj, scores


def _mlp_macs_per_token(cfg: ModelConfig):
    if cfg.d_ff == 0:
        return 0.0
    mult = 3 if cfg.act == "silu" else 2
    if cfg.is_moe:
        return cfg.top_k * cfg.capacity_factor * mult * cfg.d_model * cfg.d_ff \
            + cfg.d_model * cfg.n_experts        # router
    return mult * cfg.d_model * cfg.d_ff


def _block_macs_per_token(cfg: ModelConfig, kind: str, s_ctx, *, decode):
    d, hd, H = cfg.d_model, cfg.hd, cfg.n_heads
    dr = cfg.d_rnn or d
    if kind in ("attn", "enc", "dec"):
        proj, scores = _attn_macs_per_token(cfg, s_ctx, decode=decode)
        m = proj + scores
        if kind == "dec":   # cross-attention (kv over audio ctx = 1500)
            proj2, scores2 = _attn_macs_per_token(cfg, 1500, decode=True)
            m += proj2 + scores2
    elif kind == "attn_local":
        win = min(cfg.window or s_ctx, s_ctx)
        proj, scores = _attn_macs_per_token(cfg, win, decode=True)
        m = proj + scores
    elif kind == "rg":
        m = 3 * d * dr + dr * d + cfg.conv_width * dr
    elif kind == "mlstm":
        m = 4 * d * H * hd + 2 * d * H \
            + (cfg.chunk * H * hd * 2) + 3 * H * hd * hd
    elif kind == "slstm":
        m = 5 * d * d
    else:
        raise ValueError(kind)
    return m + _mlp_macs_per_token(cfg)


def _pattern_counts(cfg: ModelConfig):
    from repro_torch.models.transformer import family_pattern
    if cfg.family == "encdec":
        return {"enc": cfg.n_enc_layers or cfg.n_layers, "dec": cfg.n_layers}
    pat = family_pattern(cfg)
    counts = {}
    for i in range(cfg.n_layers):
        k = pat[i % len(pat)]
        counts[k] = counts.get(k, 0) + 1
    return counts


def forward_macs(cfg: ModelConfig, seq: int, batch: int, kind: str) -> float:
    """Total forward MACs for the whole (global) batch."""
    decode = kind == "decode"
    tokens = batch * (1 if decode else seq)
    counts = _pattern_counts(cfg)
    total = 0.0
    for block_kind, n in counts.items():
        if block_kind == "enc":
            enc_tokens = batch * 1500
            total += n * enc_tokens * _block_macs_per_token(
                cfg, "enc", 1500, decode=False)
        else:
            total += n * tokens * _block_macs_per_token(
                cfg, block_kind, seq, decode=decode)
    total += tokens * cfg.d_model * cfg.vocab_size      # unembed
    return total


def cell_flops_per_device(cfg: ModelConfig, seq: int, batch: int, kind: str,
                          n_chips: int) -> float:
    fwd = forward_macs(cfg, seq, batch, kind)
    if kind == "train":
        remat = {"none": 0.0, "dots": 0.5, "full": 1.0}[cfg.remat]
        macs = fwd * (3.0 + remat)
    else:
        macs = fwd
    return 2.0 * macs / n_chips


def _dtype_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.dtype in ("bf16", "fp16") else 4


def cell_hbm_bytes_per_device(cfg: ModelConfig, seq: int, batch: int,
                              kind: str, n_chips: int) -> float:
    """Per-device HBM traffic for one step."""
    act_b = _dtype_bytes(cfg)
    n_params = cfg.n_params
    counts = _pattern_counts(cfg)
    n_layers_total = sum(counts.values())
    param_b = 2 if cfg.params_dtype == "bf16" else 4
    if kind == "train":
        # opt update r/w: m,v f32 + param read/write at storage dtype;
        # fwd/bwd weight reads stream at storage dtype
        opt = n_params / n_chips * (4 * 4 + 2 * param_b)
        wread = n_params / n_chips * param_b * 3
        tokens_local = batch * seq / n_chips
        acts = tokens_local * cfg.d_model * act_b * 8 * n_layers_total
        return opt + wread + acts
    serve_b = 1 if cfg.serve_quant else act_b
    # serving: tp_only replicates params across DP — per-device weight
    # reads cover the model-shard, fsdp covers 1/n_chips then gathers
    model_shard = 16 if cfg.serve_param_mode == "tp_only" else n_chips
    if kind == "prefill":
        wread = n_params * serve_b / model_shard
        tokens_local = batch * seq / n_chips
        acts = tokens_local * cfg.d_model * act_b * 8 * n_layers_total
        return wread + acts
    # decode
    wread = n_params * serve_b / model_shard
    cache = 0.0
    hd = cfg.hd
    for k, n in counts.items():
        if k in ("attn", "dec"):
            cache += n * batch * seq * cfg.n_kv_heads * hd * 2 * act_b
        elif k == "attn_local":
            win = min(cfg.window or seq, seq)
            cache += n * batch * win * cfg.n_kv_heads * hd * 2 * act_b
        elif k == "rg":
            dr = cfg.d_rnn or cfg.d_model
            cache += n * batch * dr * 4 * 2
        elif k == "mlstm":
            cache += n * batch * cfg.n_heads * hd * hd * 4 * 2
        elif k == "slstm":
            cache += n * batch * cfg.d_model * 4 * 4
    return wread + cache / n_chips + batch * cfg.d_model * act_b


def cell_wire_bytes_per_device(cfg: ModelConfig, seq: int, batch: int,
                               kind: str, n_chips: int) -> float:
    """Bytes one device receives over the interconnect in one step."""
    if kind != "decode" or n_chips <= 1:
        return 0.0
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels.census import pool_gather_work
    pol = get_policy(cfg.policy)
    n_attn = sum(n for k, n in _pattern_counts(cfg).items()
                 if k in ("attn", "dec"))
    if pol.kv_quantized:
        return n_attn * pool_gather_work(
            n_chips, batch * seq * cfg.n_kv_heads, cfg.hd, pol.fmt_kv,
            pol.kv_packed)
    # max, denominator (B, H) and numerator (B, H, hd) from each other rank
    return n_attn * (n_chips - 1) * batch * cfg.n_heads * (2 + cfg.hd) * 4.0
