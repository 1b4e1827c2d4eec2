"""The port's routing table: every `core.exec_plan` route of the port's
slices (port of `repro.kernels.registry`, without the reference's
training and TP ops).

Each op's lowest-priority route is a plain PyTorch route whose predicate
checks only semantic viability.  The kernel routes' predicates follow the
reference's; whether a kernel route runs its CUDA kernel or its plain
version is the wrapper's decision, by the device its tensors lie on — a
CUDA tensor takes the kernel or raises.  No environment variable turns a
kernel route off.

Uniform run signatures per op (a CUDA route also takes its launch-plan
`knobs` as keywords, and its `plan(policy, ctx, **knobs)` says which
launch they give at ctx or raises `ValueError`; the tuner sweeps them):

  matmul          run(x, lin, policy) -> (..., N); knobs bn, split
  grouped_matmul  run(x, lin, policy, *, eq) -> einsum output, x.dtype;
                      knobs bn, split
  flash_attn      run(q, k, v, *, policy, causal, window, offset, valid,
                      scale, kv_on_grid) -> (B, Sq, H, hd); knobs bq, bk
  decode_attn     run(q, cache, offset, *, policy, scale) -> (B, 1, H, hd)
  paged_decode    run(q, cache, positions, *, policy, scale)
                      -> (B, 1, H, hd)
  verify_attn     run(q, cache, positions, *, policy, scale)
                      -> (B, S_q, H, hd)
  unembed         run(x, table, policy, *, per_row=False)
                      -> (B, S, V) f32
  quantize_pack   run(x, *, fmt, pack, bm=None) -> (codes, (M, 1) f32
                      scales); bm, the reference's row tile, is ignored;
                      knobs lanes, nv

The paged routes declare no knobs: their cluster split sets the bits of
the sum, and the verify fold must keep the decode step's
(`kernels/paged_decode.py:fold_plan`).  `tests` names each route's
`tests/test_torch_*.py` files (`launch/plan_table.py --check`).
"""
from __future__ import annotations


import torch

from repro_torch.core import exec_plan
from repro_torch.core.device import batched_rowwise_dot, rowwise_dot
from repro_torch.core.linear import GROUPED_EQS
from repro_torch.core.packing import operand_nbytes, pack_fp4_axis
from repro_torch.core.quantize import fake_quant
from repro_torch.kernels import dpa_matmul as DM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_decode as PD
from repro_torch.kernels import quantize as QZ
from repro_torch.models import decode_attn as D

# torch dtypes accepted as pre-quantized weights (their route is a later
# slice; the predicates below keep the fused kernel off them)
NATIVE_NARROW = ("float8_e4m3fn", "float8_e5m2")

# kernel vs plain version on the card: the max-abs error chip_smoke.py
# holds the paged-decode kernel to (its check_paged says why)
PAGED_DECODE_CARD_TOL = 2e-2
# ... per attention format.  The E4M3 pin splits into one bf16 ulp of an
# output below 4 (2^-6: the kernel and the plain version round their f32
# outputs apart) and 2e-2 - 2^-6 for p-code flips (a logit summed in
# another order crosses a rounding boundary of the grid).  A flip's
# weight in an output is at most max over adjacent codes lo < hi of
# (hi - lo) / (T + lo), the step against the least denominator, which
# holds the top code T of the max key: E4M3 32 / (448 + 256) = 1/22,
# E2M1 2 / (6 + 4) = 1/5, fp16 8 / (16384 + 8192) = 1/3072.  Each
# format's flip allowance is E4M3's scaled by that weight, plus the ulp.
_BF16_ULP_BELOW_4 = 2.0 ** -6
_FLIP_WEIGHT = {"fp8_e4m3": 1 / 22, "fp4_e2m1": 1 / 5, "fp16": 1 / 3072}
PAGED_DECODE_CARD_TOLS = {
    fmt: _BF16_ULP_BELOW_4 + (PAGED_DECODE_CARD_TOL - _BF16_ULP_BELOW_4)
    * w / _FLIP_WEIGHT["fp8_e4m3"] for fmt, w in _FLIP_WEIGHT.items()}
# These are worst cases over any inputs.  chip_smoke.py also holds each
# case to its own, far smaller, bound (`_paged_case_tol`, from the case's
# own sum of codes).


def _pd_tol(policy, ctx):
    """The paged kernel's routes' bound: their attention format's (None
    for the formats the kernel refuses)."""
    return PAGED_DECODE_CARD_TOLS.get(policy.fmt_attn)

# the flash routes' q and key block, cut to divide the sequence: part of
# the DPA flash numerics (p is quantized per key block)
FLASH_BLOCK = 128


def _kv_fmt(policy):
    return policy.fmt_kv if policy.kv_quantized else None


# -----------------------------------------------------------------------------
# matmul
# -----------------------------------------------------------------------------

def _prepared(lin):
    if "wq" not in lin:
        raise ValueError("the DPA kernels consume load-time weights: "
                         "prepare the params (core.linear.prepare_linear / "
                         "prepare_grouped_linear, done by Model.init and "
                         "models.convert)")
    return lin


def _mm_fused(x, lin, policy, *, bn=None, split=None):
    return kops.dpa_matmul_fused_pipeline(x, _prepared(lin), policy, bn=bn,
                                          split=split)


def _mm_prequant(x, lin, policy, *, bn=None, split=None):
    return kops.dpa_matmul_prequant_pipeline(x, _prepared(lin), policy,
                                             bn=bn, split=split)


def _up(v: int, mult: int) -> int:
    return -(-v // mult) * mult


def _mm_dims(ctx):
    """(E, M, K, N) the kernel sees for a linear's ctx: the pipelines pad
    M to min(128, max(8, M)), K to 128 and (at load) N to 128.  Raises
    `ValueError` where the ctx carries no shape."""
    m, k, n = ctx.get("m"), ctx.get("k"), ctx.get("n")
    if not (m and k and n):
        raise ValueError(f"no launch plan without m, k, n; ctx {ctx}")
    return (int(ctx.get("e", 1)), _up(m, min(128, max(8, m))), _up(k, DM.BK),
            _up(n, 128))


def _fused_plan(policy, ctx, *, bn=None, split=None):
    return DM.fused_plan(*_mm_dims(ctx), bn=bn, split=split)


def _prequant_plan(policy, ctx, *, bn=None, split=None):
    return DM.prequant_plan(*_mm_dims(ctx), bn=bn, split=split)


MM_KNOBS = ("bn", "split")


def _mm_fake_quant(x, lin, policy):
    w = lin["w"].to(x.dtype)
    wq = fake_quant(
        w, policy.fmt_weights,
        dim=0 if policy.w_granularity == "per_channel" else None,
        block=policy.block_size if policy.w_granularity == "per_block"
        else None)
    xq = fake_quant(
        x, policy.fmt_acts,
        dim=-1 if policy.a_granularity == "per_channel" else None,
        block=policy.block_size if policy.a_granularity == "per_block"
        else None)
    return rowwise_dot(xq, wq.t())


def _mm_f32(x, lin, policy):
    return rowwise_dot(x, lin["w"].to(x.dtype).t())


def _mm_operand_bytes(policy, ctx):
    m, k, n = ctx.get("m"), ctx.get("k"), ctx.get("n")
    if not (m and k and n):
        return None
    return (operand_nbytes(m * k, policy.fmt_acts, packed=policy.packed)
            + operand_nbytes(k * n, policy.fmt_weights, packed=policy.packed))


exec_plan.register(
    "matmul", "cuda_fused", backend="cuda", run=_mm_fused,
    priority=30, reference="torch_fake_quant", tol=0.35,
    knobs=MM_KNOBS, plan=_fused_plan,
    tests=("tests/test_torch_dpa_matmul.py", "tests/test_torch_fused_plan.py",
           "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {
        "kernel_path": policy.use_kernel,
        "fused_quant": policy.fused_quant,
        "float_weights": ctx.get("w_dtype") not in NATIVE_NARROW,
        "dpa_enabled": policy.enabled},
    bytes_moved=_mm_operand_bytes,
    note="in-kernel activation quantize, per-(row, K-block) scales")

exec_plan.register(
    "matmul", "cuda_prequant", backend="cuda", run=_mm_prequant,
    priority=25, reference="torch_fake_quant", tol=0.35,
    knobs=MM_KNOBS, plan=_prequant_plan,
    tests=("tests/test_torch_dpa_matmul.py",
           "tests/test_torch_prequant_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {
        "kernel_path": policy.use_kernel,
        "prequant": not policy.fused_quant,
        "float_weights": ctx.get("w_dtype") not in NATIVE_NARROW,
        "dpa_enabled": policy.enabled},
    bytes_moved=_mm_operand_bytes,
    note="plain quantize pass, packed fp4 operand bytes when policy.packed")

exec_plan.register(
    "matmul", "torch_fake_quant", backend="torch", run=_mm_fake_quant,
    priority=10, tests=("tests/test_torch_model.py",
                        "tests/test_torch_exec_plan.py"),
    predicate=lambda policy, ctx: {"dpa_enabled": policy.enabled},
    note="STE quant-dequant operands, f32 accumulation")

exec_plan.register(
    "matmul", "torch_f32", backend="torch", run=_mm_f32, priority=0,
    tests=("tests/test_torch_model.py", "tests/test_torch_engine.py"),
    note="DPA disabled: the f32 datapath")


# -----------------------------------------------------------------------------
# grouped_matmul: per-expert einsums (grouped linear / MoE)
# -----------------------------------------------------------------------------

def _gmm_fused(x, lin, policy, *, eq, bn=None, split=None):
    return kops.dpa_grouped_fused_pipeline(x, _prepared(lin), policy, eq=eq,
                                           bn=bn, split=split)


def _gmm_prequant(x, lin, policy, *, eq, bn=None, split=None):
    return kops.dpa_grouped_prequant_pipeline(x, _prepared(lin), policy,
                                              eq=eq, bn=bn, split=split)


def _grouped_einsum(eq, x, w):
    """einsum `eq` in f32, each output summed over K in one fixed order
    (`batched_rowwise_dot` per expert)."""
    x3, unview = kops.grouped_views(eq, x)
    return unview(batched_rowwise_dot(x3, w.transpose(1, 2)))


def _gmm_fake_quant(x, lin, policy, *, eq):
    # quantize the *master* weights (no pre-cast through x.dtype, which
    # would round them twice); the stacked (E, d_in, d_out) layout puts
    # the contraction axis at 1 where dense has it at 0
    wq = fake_quant(
        lin["w"], policy.fmt_weights,
        dim=1 if policy.w_granularity == "per_channel" else None,
        block=policy.block_size if policy.w_granularity == "per_block"
        else None)
    xq = fake_quant(
        x, policy.fmt_acts,
        dim=-1 if policy.a_granularity == "per_channel" else None,
        block=policy.block_size if policy.a_granularity == "per_block"
        else None)
    return _grouped_einsum(eq, xq, wq).to(x.dtype)


def _gmm_f32(x, lin, policy, *, eq):
    return _grouped_einsum(eq, x, lin["w"].to(x.dtype)).to(x.dtype)


def _gmm_operand_bytes(policy, ctx):
    """Format-width operand bytes for the stacked per-expert matmuls."""
    e, m, k, n = ctx.get("e"), ctx.get("m"), ctx.get("k"), ctx.get("n")
    if not (e and m and k and n):
        return None
    return (operand_nbytes(e * m * k, policy.fmt_acts, packed=policy.packed)
            + operand_nbytes(e * k * n, policy.fmt_weights,
                             packed=policy.packed))


def _gmm_wide_bytes(policy, ctx):
    """Both operand stacks at full f32 width."""
    e, m, k, n = ctx.get("e"), ctx.get("m"), ctx.get("k"), ctx.get("n")
    if not (e and m and k and n):
        return None
    return 4 * (e * m * k + e * k * n)


def _gmm_kernel_bits(policy, ctx, quant_bit, quant_ok):
    return {"kernel_path": policy.use_kernel,
            quant_bit: quant_ok,
            "float_weights": ctx.get("w_dtype") not in NATIVE_NARROW,
            "known_grouped_eq": ctx.get("eq") in GROUPED_EQS,
            "dpa_enabled": policy.enabled}


exec_plan.register(
    "grouped_matmul", "cuda_grouped_fused", backend="cuda", run=_gmm_fused,
    priority=30, reference="torch_fake_quant", tol=0.35,
    knobs=MM_KNOBS, plan=_fused_plan,
    tests=("tests/test_torch_grouped_matmul.py", "tests/test_torch_moe.py",
           "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: _gmm_kernel_bits(
        policy, ctx, "fused_quant", policy.fused_quant),
    bytes_moved=_gmm_operand_bytes,
    note="per-expert in-kernel activation quantize; packed fp4 expert "
         "weights move 8x fewer resident bytes")

exec_plan.register(
    "grouped_matmul", "cuda_grouped_prequant", backend="cuda",
    run=_gmm_prequant, priority=25, reference="torch_fake_quant", tol=0.35,
    knobs=MM_KNOBS, plan=_prequant_plan,
    tests=("tests/test_torch_grouped_matmul.py",
           "tests/test_torch_prequant_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: _gmm_kernel_bits(
        policy, ctx, "prequant", not policy.fused_quant),
    bytes_moved=_gmm_operand_bytes,
    note="plain quantize pass over both stacks; packed fp4 operand bytes "
         "when policy.packed")

exec_plan.register(
    "grouped_matmul", "torch_fake_quant", backend="torch",
    run=_gmm_fake_quant, priority=10,
    tests=("tests/test_torch_grouped_matmul.py", "tests/test_torch_moe.py"),
    predicate=lambda policy, ctx: {"dpa_enabled": policy.enabled},
    bytes_moved=_gmm_wide_bytes,
    note="per-expert STE quant-dequant, f32 accumulation")

exec_plan.register(
    "grouped_matmul", "torch_f32", backend="torch", run=_gmm_f32,
    priority=0, bytes_moved=_gmm_wide_bytes,
    tests=("tests/test_torch_moe.py",),
    note="DPA disabled: plain grouped einsum")


# -----------------------------------------------------------------------------
# flash_attn: full-sequence attention (models.layers._sdpa)
# -----------------------------------------------------------------------------

def _fit_block(b, s):
    """Largest block <= b that divides the sequence length (the flash
    kernels need Sq % bq == 0 and Sk % bk == 0)."""
    b = max(1, min(b, s))
    while s % b:
        b -= 1
    return b


def _heads_first(t):
    return t.transpose(1, 2).contiguous()         # (B,S,H,d) -> (B,H,S,d)


def _flash_blocks(hd, sq, skv, bq, bk, max_q):
    """(bq, bk) of a flash launch: by default `FLASH_BLOCK` (q rows at most
    `max_q`), cut to divide the sequences; an override (both or neither,
    as the tuner's measured plans give them) is cut to the lengths and
    must divide them and stay within the kernel's blocks, or
    `ValueError`."""
    if bq is None and bk is None:
        return _fit_block(min(FLASH_BLOCK, max_q), sq), \
            _fit_block(FLASH_BLOCK, skv)
    if bq is None or bk is None:
        raise ValueError(f"a flash override takes bq and bk together; got "
                         f"bq={bq}, bk={bk}")
    bq, bk = min(int(bq), sq), min(int(bk), skv)
    if not (1 <= bq <= max_q and 1 <= bk <= FA.MAX_BLOCK) or sq % bq \
            or skv % bk:
        raise ValueError(f"flash blocks must divide Sq={sq} / Sk={skv} "
                         f"within bq <= {max_q}, bk <= {FA.MAX_BLOCK} at hd "
                         f"{hd}; got bq={bq}, bk={bk}")
    return bq, bk


def _fa_dims(ctx):
    hd, sq, skv = ctx.get("hd"), ctx.get("sq"), ctx.get("skv")
    if not (hd and sq and skv):
        raise ValueError(f"no launch plan without hd, sq, skv; ctx {ctx}")
    return hd, sq, skv


def _fa_dpa_plan(policy, ctx, *, bq=None, bk=None):
    hd, sq, skv = _fa_dims(ctx)
    return _flash_blocks(hd, sq, skv, bq, bk, FA.max_bq(hd))


def _fa_f32_plan(policy, ctx, *, bq=None, bk=None):
    hd, sq, skv = _fa_dims(ctx)
    return _flash_blocks(hd, sq, skv, bq, bk, FA.MAX_BLOCK)


def _fa_cuda_dpa(q, k, v, *, policy, causal, window, offset, valid, scale,
                 kv_on_grid, bq=None, bk=None):
    bq, bk = _fa_dpa_plan(policy, dict(hd=q.shape[-1], sq=q.shape[1],
                                       skv=k.shape[1]), bq=bq, bk=bk)
    out = FA.dpa_flash_attention(
        _heads_first(q), _heads_first(k), _heads_first(v),
        fmt=policy.fmt_attn, fmt_kv=_kv_fmt(policy), causal=causal,
        window=window, bq=bq, bk=bk)
    return out.transpose(1, 2)


def _fa_cuda_f32(q, k, v, *, policy, causal, window, offset, valid, scale,
                 kv_on_grid, bq=None, bk=None):
    bq, bk = _fa_f32_plan(policy, dict(hd=q.shape[-1], sq=q.shape[1],
                                       skv=k.shape[1]), bq=bq, bk=bk)
    out = FA.flash_attention(
        _heads_first(q), _heads_first(k), _heads_first(v), causal=causal,
        window=window, bq=bq, bk=bk)
    return out.transpose(1, 2)


FA_KNOBS = ("bq", "bk")


def _fa_dpa(q, k, v, *, policy, causal, window, offset, valid, scale,
            kv_on_grid):
    mask = D.build_sdpa_mask(q.shape[1], k.shape[1], offset, causal, window,
                             valid, device=q.device)
    return D.dpa_attention(q, k, v, mask[None, None], fmt=policy.fmt_attn,
                           fmt_kv=_kv_fmt(policy), scale=scale,
                           kv_on_grid=kv_on_grid)


def _fa_ref(q, k, v, *, policy, causal, window, offset, valid, scale,
            kv_on_grid):
    mask = D.build_sdpa_mask(q.shape[1], k.shape[1], offset, causal, window,
                             valid, device=q.device)
    return D.sdpa_reference(q, k, v, mask[None, None], scale=scale)


def _fa_common_bits(policy, ctx):
    return {"flash_enabled": ctx.get("use_flash", False),
            "is_prefill": ctx.get("sq", 1) > 1,
            "no_valid_mask": not ctx.get("has_valid", False)}


exec_plan.register(
    "flash_attn", "cuda_dpa_flash", backend="cuda", run=_fa_cuda_dpa,
    priority=30, reference="torch_dpa_attn", tol=0.075,
    knobs=FA_KNOBS, plan=_fa_dpa_plan,
    tests=("tests/test_torch_flash_attention.py",
           "tests/test_torch_flash_plan.py", "tests/test_torch_prefill.py",
           "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: dict(
        _fa_common_bits(policy, ctx),
        dpa_attn=policy.attn_enabled,
        raw_kv=not ctx.get("kv_on_grid", False)),
    note="online-softmax tiling; tol vs the global-softmax route is the "
         "blocked-p-quantization budget")

exec_plan.register(
    "flash_attn", "cuda_f32_flash", backend="cuda", run=_fa_cuda_f32,
    priority=20, reference="torch_ref_attn", tol=2e-6,
    knobs=FA_KNOBS, plan=_fa_f32_plan,
    tests=("tests/test_torch_flash_attention.py",
           "tests/test_torch_attn_plan.py", "tests/test_torch_prefill.py",
           "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: dict(
        _fa_common_bits(policy, ctx), f32_attn=not policy.attn_enabled),
    note="the seed f32 flash kernel")

exec_plan.register(
    "flash_attn", "torch_dpa_attn", backend="torch", run=_fa_dpa,
    priority=10, tests=("tests/test_torch_flash_attention.py",
                        "tests/test_torch_model.py"),
    predicate=lambda policy, ctx: {"dpa_attn": policy.attn_enabled},
    note="any-shape DPA attention (global softmax max)")

exec_plan.register(
    "flash_attn", "torch_ref_attn", backend="torch", run=_fa_ref,
    priority=0, tests=("tests/test_torch_flash_attention.py",
                       "tests/test_torch_model.py"), note="f32 logits + softmax (the seed datapath)")


# -----------------------------------------------------------------------------
# decode_attn: single-token decode over the contiguous quantized cache
# -----------------------------------------------------------------------------

def _kv_rows_bytes(policy, n_rows, hd):
    """codes + f32 scales for K and V over n_rows cache rows."""
    return 2 * (operand_nbytes(n_rows * hd, policy.fmt_kv,
                               packed=policy.kv_packed) + 4 * n_rows)


def _da_dpa(q, cache, offset, *, policy, scale):
    return D.dpa_decode_attn(q, cache, offset, fmt=policy.fmt_attn,
                             fmt_kv=policy.fmt_kv,
                             kv_packed=policy.kv_packed, scale=scale)


exec_plan.register(
    "decode_attn", "torch_dpa_decode", backend="torch", run=_da_dpa,
    priority=0, tests=("tests/test_torch_model.py",
                       "tests/test_torch_kvcache.py"),
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    bytes_moved=lambda policy, ctx: _kv_rows_bytes(
        policy, ctx.get("batch", 1) * ctx.get("s_ctx", 0)
        * ctx.get("kv_heads", 1), ctx.get("hd", 0)),
    note="prologue-dequant decode off the contiguous codes+scales cache")


# -----------------------------------------------------------------------------
# paged_decode: single-token decode over the paged cache (block table)
# -----------------------------------------------------------------------------

def _pd_kernel(q, cache, positions, *, policy, scale):
    return PD.paged_decode_attention(
        q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
        cache["v_scale"], cache["block_table"], positions,
        fmt=policy.fmt_attn, fmt_kv=policy.fmt_kv,
        kv_packed=policy.kv_packed, scale=scale)


def _pd_gather(q, cache, positions, *, policy, scale):
    return D.dpa_paged_decode_attn(q, cache, positions, fmt=policy.fmt_attn,
                                   fmt_kv=policy.fmt_kv,
                                   kv_packed=policy.kv_packed, scale=scale)


def _pd_view_rows(ctx):
    return (ctx.get("batch", 1) * ctx.get("max_pages", 0)
            * ctx.get("page_size", 0) * ctx.get("kv_heads", 1))


exec_plan.register(
    "paged_decode", "cuda_block_table", backend="cuda", run=_pd_kernel,
    priority=10, reference="torch_gather", tol=_pd_tol,
    tests=("tests/test_torch_paged_decode.py",
           "tests/test_torch_attn_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    bytes_moved=lambda policy, ctx: _kv_rows_bytes(
        policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="pages read through the block table; live rows only, codes + "
         "scales streamed from device memory once per pass")

exec_plan.register(
    "paged_decode", "torch_gather", backend="torch", run=_pd_gather,
    priority=0, tests=("tests/test_torch_paged_decode.py",),
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    bytes_moved=lambda policy, ctx: 3 * _kv_rows_bytes(
        policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="gather_paged_kv re-materializes the contiguous view")


# -----------------------------------------------------------------------------
# verify_attn: S_q causal query tokens scored against the paged cache (the
# speculative-decoding verify pass; see serving.spec_decode)
# -----------------------------------------------------------------------------

def _va_gather(q, cache, positions, *, policy, scale):
    return D.dpa_paged_verify_attn(q, cache, positions, fmt=policy.fmt_attn,
                                   fmt_kv=policy.fmt_kv,
                                   kv_packed=policy.kv_packed, scale=scale)


exec_plan.register(
    "verify_attn", "cuda_block_table", backend="cuda", run=_pd_kernel,
    priority=10, reference="torch_gather", tol=_pd_tol,
    tests=("tests/test_torch_spec_decode.py",
           "tests/test_torch_attn_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    # the fold reads each query row's live rows: S_q passes over the view
    bytes_moved=lambda policy, ctx: ctx.get("sq", 1) * _kv_rows_bytes(
        policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="the paged decode kernel over B x S_q rows, one launch: row (b, "
         "i) reads table row b at position positions[b] + i, with the "
         "decode step's split, so it carries the decode step's bits")

exec_plan.register(
    "verify_attn", "torch_gather", backend="torch", run=_va_gather,
    priority=0, tests=("tests/test_torch_spec_decode.py",),
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    # gather re-materializes the view (the 3x of paged_decode's), then the
    # batch fold repeats it per query row (write + attention read: 2 more
    # view passes per query row)
    bytes_moved=lambda policy, ctx: (3 + 2 * ctx.get("sq", 1))
    * _kv_rows_bytes(policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="per-request causal mask over the gathered block-table view, the "
         "(B, S_q) query axis folded into the batch, so row i reduces as "
         "a decode step at positions[b] + i")


# -----------------------------------------------------------------------------
# unembed: f32 logits over the (tied) vocab table
# -----------------------------------------------------------------------------

def _ue_tied(x, table, policy, *, per_row=False):
    # f32 products of the compute-dtype operands (the table rounded to
    # x's dtype), f32 sums: a bf16 matmul would round the logits to bf16
    # and turn greedy near-ties into different tokens.  `per_row` (the
    # verify pass on the card): x (B, S, d) as S products of (B, 1, d),
    # the decode step's shape, since cuBLAS picks its kernel by the rows;
    # the table widens to f32 once for all of them (`rowwise_dot` widens
    # it on each call otherwise: the same values)
    t = table.to(x.dtype)
    if not per_row:
        return rowwise_dot(x, t)
    t = t.to(torch.float32)
    return torch.cat([rowwise_dot(x[:, i:i + 1].contiguous(), t)
                      for i in range(x.shape[1])], dim=1)


exec_plan.register(
    "unembed", "torch_tied_table", backend="torch", run=_ue_tied,
    priority=0, tests=("tests/test_torch_model.py",
                       "tests/test_torch_spec_decode.py"),
    bytes_moved=lambda policy, ctx: 4 * ctx.get("size", 0),
    note="f32-accumulation logits over the embedding table")


# -----------------------------------------------------------------------------
# quantize_pack: row quantization (+fp4 nibble pack)
# -----------------------------------------------------------------------------

def _qp_cuda(x, *, fmt, pack, lanes=None, nv=None, **_):
    # bm, the reference's row tile, is swallowed: the kernel's launch plan
    # (`quantize_plan`) groups threads by row over any row count
    if pack:
        if fmt != "fp4_e2m1":
            raise ValueError("pack=True is the fp4 pipeline")
        return QZ.quantize_pack_rows(x.contiguous(), lanes=lanes, nv=nv)
    return QZ.quantize_rows(x.contiguous(), fmt=fmt, lanes=lanes, nv=nv)


def _qp_plan(policy, ctx, *, lanes=None, nv=None):
    m, k = ctx.get("m"), ctx.get("k")
    if not (m and k):
        raise ValueError(f"no launch plan without m, k; ctx {ctx}")
    dtype = getattr(torch, ctx.get("x_dtype", "float32"))
    return QZ.quantize_plan(m, k, dtype, ctx.get("fmt"),
                            pack=bool(ctx.get("pack", False)), lanes=lanes,
                            nv=nv)


def _qp_torch(x, *, fmt, pack, **_):
    # swallows bm: the plain quantizer has no tiling to tune
    q, s = QZ.quantize_rows_ref(x, fmt=fmt)
    if pack:
        q = pack_fp4_axis(q, 1)
    return q, s


exec_plan.register(
    "quantize_pack", "cuda_quantize_pack", backend="cuda", run=_qp_cuda,
    priority=20, reference="torch_quantize", tol=0.0,
    knobs=("lanes", "nv"), plan=_qp_plan,
    tests=("tests/test_torch_quantize_rows.py",
           "tests/test_torch_quantize_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {"fp4": ctx.get("fmt") == "fp4_e2m1",
                                   "pack": ctx.get("pack", False)},
    note="absmax -> E2M1 cast -> nibble pack, one kernel")

exec_plan.register(
    "quantize_pack", "cuda_quantize_rows", backend="cuda", run=_qp_cuda,
    priority=10, reference="torch_quantize", tol=0.0,
    knobs=("lanes", "nv"), plan=_qp_plan,
    tests=("tests/test_torch_quantize_rows.py",
           "tests/test_torch_quantize_plan.py", "tests/test_torch_tuner.py"),
    predicate=lambda policy, ctx: {"unpacked": not ctx.get("pack", False)},
    note="absmax + cast row quantizer")

exec_plan.register(
    "quantize_pack", "torch_quantize", backend="torch", run=_qp_torch,
    priority=0, tests=("tests/test_torch_quantize_rows.py",),
    predicate=lambda policy, ctx: {
        "pack_needs_fp4": (not ctx.get("pack", False))
        or ctx.get("fmt") == "fp4_e2m1"},
    note="plain quantizer (+ nibble pack)")
