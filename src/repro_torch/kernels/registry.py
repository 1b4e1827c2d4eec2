"""The port's routing table: every `core.exec_plan` route of the port's
slices (port of `repro.kernels.registry`, without the reference's
training, TP and speculative-decoding ops).

Each op's lowest-priority route is a plain PyTorch route whose predicate
checks only semantic viability.  The kernel routes' predicates follow the
reference's; whether a kernel route runs its CUDA kernel or its plain
version is the wrapper's decision, by the device its tensors lie on — a
CUDA tensor takes the kernel or raises.  No environment variable turns a
kernel route off.

Uniform run signatures per op:

  matmul          run(x, lin, policy) -> (..., N)
  grouped_matmul  run(x, lin, policy, *, eq) -> einsum output, x.dtype
  flash_attn      run(q, k, v, *, policy, causal, window, offset, valid,
                      scale, kv_on_grid) -> (B, Sq, H, hd)
  decode_attn     run(q, cache, offset, *, policy, scale) -> (B, 1, H, hd)
  paged_decode    run(q, cache, positions, *, policy, scale)
                      -> (B, 1, H, hd)
  unembed         run(x, table, policy) -> (B, S, V) f32
  quantize_pack   run(x, *, fmt, pack, bm=None) -> (codes, (M, 1) f32
                      scales); bm, the reference's row tile, is ignored
"""
from __future__ import annotations


from repro_torch.core import exec_plan
from repro_torch.core.device import batched_rowwise_dot, rowwise_dot
from repro_torch.core.linear import GROUPED_EQS
from repro_torch.core.packing import operand_nbytes, pack_fp4_axis
from repro_torch.core.quantize import fake_quant
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


def _mm_fused(x, lin, policy):
    return kops.dpa_matmul_fused_pipeline(x, _prepared(lin), policy)


def _mm_prequant(x, lin, policy):
    return kops.dpa_matmul_prequant_pipeline(x, _prepared(lin), policy)


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
    predicate=lambda policy, ctx: {
        "kernel_path": policy.use_kernel,
        "prequant": not policy.fused_quant,
        "float_weights": ctx.get("w_dtype") not in NATIVE_NARROW,
        "dpa_enabled": policy.enabled},
    bytes_moved=_mm_operand_bytes,
    note="plain quantize pass, packed fp4 operand bytes when policy.packed")

exec_plan.register(
    "matmul", "torch_fake_quant", backend="torch", run=_mm_fake_quant,
    priority=10,
    predicate=lambda policy, ctx: {"dpa_enabled": policy.enabled},
    note="STE quant-dequant operands, f32 accumulation")

exec_plan.register(
    "matmul", "torch_f32", backend="torch", run=_mm_f32, priority=0,
    note="DPA disabled: the f32 datapath")


# -----------------------------------------------------------------------------
# grouped_matmul: per-expert einsums (grouped linear / MoE)
# -----------------------------------------------------------------------------

def _gmm_fused(x, lin, policy, *, eq):
    return kops.dpa_grouped_fused_pipeline(x, _prepared(lin), policy, eq=eq)


def _gmm_prequant(x, lin, policy, *, eq):
    return kops.dpa_grouped_prequant_pipeline(x, _prepared(lin), policy,
                                              eq=eq)


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
    predicate=lambda policy, ctx: _gmm_kernel_bits(
        policy, ctx, "fused_quant", policy.fused_quant),
    bytes_moved=_gmm_operand_bytes,
    note="per-expert in-kernel activation quantize; packed fp4 expert "
         "weights move 8x fewer resident bytes")

exec_plan.register(
    "grouped_matmul", "cuda_grouped_prequant", backend="cuda",
    run=_gmm_prequant, priority=25, reference="torch_fake_quant", tol=0.35,
    predicate=lambda policy, ctx: _gmm_kernel_bits(
        policy, ctx, "prequant", not policy.fused_quant),
    bytes_moved=_gmm_operand_bytes,
    note="plain quantize pass over both stacks; packed fp4 operand bytes "
         "when policy.packed")

exec_plan.register(
    "grouped_matmul", "torch_fake_quant", backend="torch",
    run=_gmm_fake_quant, priority=10,
    predicate=lambda policy, ctx: {"dpa_enabled": policy.enabled},
    bytes_moved=_gmm_wide_bytes,
    note="per-expert STE quant-dequant, f32 accumulation")

exec_plan.register(
    "grouped_matmul", "torch_f32", backend="torch", run=_gmm_f32,
    priority=0, bytes_moved=_gmm_wide_bytes,
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


def _fa_cuda_dpa(q, k, v, *, policy, causal, window, offset, valid, scale,
                 kv_on_grid):
    out = FA.dpa_flash_attention(
        _heads_first(q), _heads_first(k), _heads_first(v),
        fmt=policy.fmt_attn, fmt_kv=_kv_fmt(policy), causal=causal,
        window=window, bq=_fit_block(FLASH_BLOCK, q.shape[1]),
        bk=_fit_block(FLASH_BLOCK, k.shape[1]))
    return out.transpose(1, 2)


def _fa_cuda_f32(q, k, v, *, policy, causal, window, offset, valid, scale,
                 kv_on_grid):
    out = FA.flash_attention(
        _heads_first(q), _heads_first(k), _heads_first(v), causal=causal,
        window=window, bq=_fit_block(FLASH_BLOCK, q.shape[1]),
        bk=_fit_block(FLASH_BLOCK, k.shape[1]))
    return out.transpose(1, 2)


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
    predicate=lambda policy, ctx: dict(
        _fa_common_bits(policy, ctx),
        dpa_attn=policy.attn_enabled,
        raw_kv=not ctx.get("kv_on_grid", False)),
    note="online-softmax tiling; tol vs the global-softmax route is the "
         "blocked-p-quantization budget")

exec_plan.register(
    "flash_attn", "cuda_f32_flash", backend="cuda", run=_fa_cuda_f32,
    priority=20, reference="torch_ref_attn", tol=2e-6,
    predicate=lambda policy, ctx: dict(
        _fa_common_bits(policy, ctx), f32_attn=not policy.attn_enabled),
    note="the seed f32 flash kernel")

exec_plan.register(
    "flash_attn", "torch_dpa_attn", backend="torch", run=_fa_dpa,
    priority=10,
    predicate=lambda policy, ctx: {"dpa_attn": policy.attn_enabled},
    note="any-shape DPA attention (global softmax max)")

exec_plan.register(
    "flash_attn", "torch_ref_attn", backend="torch", run=_fa_ref,
    priority=0, note="f32 logits + softmax (the seed datapath)")


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
    priority=0,
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
    priority=10, reference="torch_gather", tol=PAGED_DECODE_CARD_TOL,
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    bytes_moved=lambda policy, ctx: _kv_rows_bytes(
        policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="pages read through the block table; live rows only, codes + "
         "scales streamed from device memory once per pass")

exec_plan.register(
    "paged_decode", "torch_gather", backend="torch", run=_pd_gather,
    priority=0,
    predicate=lambda policy, ctx: {"kv_quantized": policy.kv_quantized},
    bytes_moved=lambda policy, ctx: 3 * _kv_rows_bytes(
        policy, _pd_view_rows(ctx), ctx.get("hd", 0)),
    note="gather_paged_kv re-materializes the contiguous view")


# -----------------------------------------------------------------------------
# unembed: f32 logits over the (tied) vocab table
# -----------------------------------------------------------------------------

def _ue_tied(x, table, policy):
    # f32 products of the compute-dtype operands (the table rounded to
    # x's dtype), f32 sums: a bf16 matmul would round the logits to bf16
    # and turn greedy near-ties into different tokens
    return rowwise_dot(x, table.to(x.dtype))


exec_plan.register(
    "unembed", "torch_tied_table", backend="torch", run=_ue_tied,
    priority=0,
    bytes_moved=lambda policy, ctx: 4 * ctx.get("size", 0),
    note="f32-accumulation logits over the embedding table")


# -----------------------------------------------------------------------------
# quantize_pack: row quantization (+fp4 nibble pack)
# -----------------------------------------------------------------------------

def _qp_cuda(x, *, fmt, pack, **_):
    # bm, the reference's row tile, is swallowed: the kernel's launch plan
    # (`quantize_plan`) groups threads by row over any row count
    if pack:
        if fmt != "fp4_e2m1":
            raise ValueError("pack=True is the fp4 pipeline")
        return QZ.quantize_pack_rows(x.contiguous())
    return QZ.quantize_rows(x.contiguous(), fmt=fmt)


def _qp_torch(x, *, fmt, pack, **_):
    # swallows bm: the plain quantizer has no tiling to tune
    q, s = QZ.quantize_rows_ref(x, fmt=fmt)
    if pack:
        q = pack_fp4_axis(q, 1)
    return q, s


exec_plan.register(
    "quantize_pack", "cuda_quantize_pack", backend="cuda", run=_qp_cuda,
    priority=20, reference="torch_quantize", tol=0.0,
    predicate=lambda policy, ctx: {"fp4": ctx.get("fmt") == "fp4_e2m1",
                                   "pack": ctx.get("pack", False)},
    note="absmax -> E2M1 cast -> nibble pack, one kernel")

exec_plan.register(
    "quantize_pack", "cuda_quantize_rows", backend="cuda", run=_qp_cuda,
    priority=10, reference="torch_quantize", tol=0.0,
    predicate=lambda policy, ctx: {"unpacked": not ctx.get("pack", False)},
    note="absmax + cast row quantizer")

exec_plan.register(
    "quantize_pack", "torch_quantize", backend="torch", run=_qp_torch,
    priority=0,
    predicate=lambda policy, ctx: {
        "pack_needs_fp4": (not ctx.get("pack", False))
        or ctx.get("fmt") == "fp4_e2m1"},
    note="plain quantizer (+ nibble pack)")
