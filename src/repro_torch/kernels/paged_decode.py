"""Block-table paged decode attention: the plain PyTorch version and the
wrapper around the CUDA kernel (`csrc/paged_decode.cu`).

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
`paged_decode_attention`: one decode step per (request, KV head) against
the paged quantized KV cache — pages read through the block table, q and
the softmax probabilities quantized per row onto the fmt grid, f32
accumulation, per-request causal mask `kpos <= positions[b]`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.models.decode_attn import dpa_paged_decode_attn

_KERNEL_KV = {("fp4_e2m1", True): 0, ("fp8_e4m3", False): 1}
KERNEL_HEAD_DIMS = (64, 128)     # the kernel's head-dim template instances


def paged_decode_attention_ref(q, k_codes, k_scale, v_codes, v_scale,
                               block_table, positions, *, fmt, fmt_kv,
                               kv_packed=False, scale=None):
    """Plain version: gather the block-table view, widen, and run
    `dpa_attention` (the reference's `jnp_gather` route)."""
    cache = {"k_codes": k_codes, "k_scale": k_scale, "v_codes": v_codes,
             "v_scale": v_scale, "block_table": block_table}
    hd = q.shape[-1]
    return dpa_paged_decode_attn(
        q, cache, positions, fmt=fmt, fmt_kv=fmt_kv, kv_packed=kv_packed,
        scale=float(scale if scale is not None else hd ** -0.5))


def _check(q, k_codes, k_scale, v_codes, v_scale, block_table, positions):
    B, sq, H, hd = q.shape
    if sq != 1:
        raise ValueError("paged decode serves single-token steps")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be f32/bf16, got {q.dtype}")
    P, page, KV = k_codes.shape[:3]
    if v_codes.shape != k_codes.shape or v_codes.dtype != k_codes.dtype:
        raise ValueError("k and v code pools must match")
    for s in (k_scale, v_scale):
        if s.shape != (P, page, KV, 1) or s.dtype != torch.float32:
            raise ValueError(f"scales must be ({P}, {page}, {KV}, 1) f32")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B:
        raise ValueError("block_table must be (B, max_pages) int32")
    if positions.dtype != torch.int32 or positions.shape != (B,):
        raise ValueError("positions must be (B,) int32")
    devs = {t.device for t in (q, k_codes, k_scale, v_codes, v_scale,
                               block_table, positions)}
    if len(devs) != 1:
        raise ValueError(f"operands span devices {devs}")


def paged_decode_attention(q, k_codes, k_scale, v_codes, v_scale,
                           block_table, positions, *, fmt, fmt_kv,
                           kv_packed=False, scale=None):
    """q (B, 1, H, hd) rope'd queries; k/v codes (P, page, KV, wc) pools
    with (P, page, KV, 1) f32 scales; block_table (B, max_pages) int32;
    positions (B,) int32 -> (B, 1, H, hd) in q's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.  `paged_decode_attention.launches` counts launches."""
    _check(q, k_codes, k_scale, v_codes, v_scale, block_table, positions)
    if q.device.type == "cpu":
        return paged_decode_attention_ref(
            q, k_codes, k_scale, v_codes, v_scale, block_table, positions,
            fmt=fmt, fmt_kv=fmt_kv, kv_packed=kv_packed, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    kv_fmt = _KERNEL_KV.get((fmt_kv, bool(kv_packed)))
    B, _, H, hd = q.shape
    KV = k_codes.shape[2]
    if fmt != "fp8_e4m3" or kv_fmt is None:
        raise NotImplementedError(
            f"paged_decode_attention kernel serves fp8_e4m3 attention over "
            f"packed fp4_e2m1 or fp8_e4m3 KV; (fmt={fmt}, fmt_kv={fmt_kv}, "
            f"kv_packed={kv_packed}) is open in ROADMAP Queue 2 under "
            "paged_decode_attention (formats open)")
    if hd not in KERNEL_HEAD_DIMS or H % KV or H // KV > 8:
        raise ValueError(f"kernel needs hd in {KERNEL_HEAD_DIMS} and H/KV <= "
                         f"8; got hd={hd}, H={H}, KV={KV}")
    tensors = (q, k_codes, k_scale, v_codes, v_scale, block_table, positions)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention kernel needs contiguous "
                         "operands")
    out = torch.empty_like(q)
    lib = build.load_library()
    err = lib.paged_decode_launch(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_codes.data_ptr(),
        k_scale.data_ptr(), v_codes.data_ptr(), v_scale.data_ptr(),
        block_table.data_ptr(), positions.data_ptr(), out.data_ptr(), B, H,
        KV, hd, k_codes.shape[1], block_table.shape[1], kv_fmt,
        float(scale if scale is not None else hd ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
