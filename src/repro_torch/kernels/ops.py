"""Public wrappers around the kernels: policy-level padding, slicing and
weight preparation (port of `repro.kernels.ops`).

The reference quantizes the f32 master weights again on every call
(`ops.py:_prep_weights`, `_prep_grouped_weights`).  The port quantizes,
pads and packs them once, at load (`prep_weights`,
`prep_grouped_weights`), with the same numerics — per-column scale by
`compute_scale`, `encode_fp4(clip(w / scale, +-6))`, nibble pack along K
— and keeps `wq`/`sw` on the device beside the master weight.  The
prequant pipelines' activation quantize pass stays plain PyTorch, as it
is an XLA pass in the reference (`_quant_operand`).
"""
from __future__ import annotations

import torch

from repro_torch.core import exec_plan
from repro_torch.core.formats import get_format
from repro_torch.core.packing import pack_fp4_axis
from repro_torch.core.policy import get_policy
from repro_torch.core.quantize import cast_to, compute_scale, encode_fp4
from repro_torch.kernels import dpa_grouped_matmul as _gm
from repro_torch.kernels import dpa_matmul as _dm


def _pad_to(x, mult, dim):
    r = x.shape[dim] % mult
    if r == 0:
        return x, 0
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - dim) + 1] = mult - r     # F.pad: last dim first
    return torch.nn.functional.pad(x, pad), mult - r


def _quant_operand(x, fmt: str, dim_scale):
    """-> (codes, f32 scale) with the scale reduced over `dim_scale`."""
    scale = compute_scale(x, fmt, dim=dim_scale)
    if fmt == "fp4_e2m1":
        t = get_format(fmt).max_finite
        return encode_fp4(torch.clamp(x.to(torch.float32) / scale, -t, t)), \
            scale
    return cast_to(x.to(torch.float32) / scale, fmt), scale


def prep_weights(w, policy, *, bk=128, bn=128) -> dict:
    """Quantize + pad + (optionally) pack one (K, N) weight for the fused
    kernel: {"wq", "sw", "n", "pack_w"}.  `w` is the weight as
    `apply_linear` hands it to the matmul, i.e. already in the
    activation dtype."""
    return _prep(w, policy, 0, bk, bn)


def prep_grouped_weights(w3, policy, *, bk=128, bn=128) -> dict:
    """The same for an (E, K, N) expert stack, per-(expert, column) scales
    ((E, 1, N)).  `w3` is the f32 master: the reference's `apply_moe`
    hands the expert weights to the grouped route uncast."""
    return _prep(w3, policy, 1, bk, bn)


def _prep(w, policy, k_dim: int, bk: int, bn: int) -> dict:
    policy = get_policy(policy)
    pack_w = policy.packed and policy.fmt_weights == "fp4_e2m1"
    wq, sw = _quant_operand(w, policy.fmt_weights, k_dim)
    wq, _ = _pad_to(wq, bk, k_dim)
    wq, _ = _pad_to(wq, bn, k_dim + 1)
    swp, _ = _pad_to(sw, bn, k_dim + 1)
    if pack_w:
        wq = pack_fp4_axis(wq, k_dim)
    return {"wq": wq.contiguous(), "sw": swp.contiguous(),
            "n": int(w.shape[-1]), "pack_w": pack_w}


def dpa_matmul_fused_pipeline(x, prep: dict, policy, *, bm=128, bk=128):
    """Fused-quant pipeline: x ships at its native width (f32/bf16) and
    quantizes in the kernel prologue; `prep` holds the load-time weights
    (`prep_weights`).  Pads M and K like the reference, slices, and casts
    the f32 output back to x's dtype."""
    policy = get_policy(policy)
    lead, K, N = x.shape[:-1], x.shape[-1], prep["n"]
    x2 = x.reshape(-1, K)
    bm_ = min(bm, max(8, x2.shape[0]))
    x2p, pm = _pad_to(x2, bm_, 0)
    x2p, _ = _pad_to(x2p, bk, 1)
    out = _dm.dpa_matmul_fused(
        x2p.contiguous(), prep["wq"], prep["sw"], fmt_x=policy.fmt_acts,
        fmt_w=policy.fmt_weights, bk=bk, pack_w=prep["pack_w"])
    out = out[: x2.shape[0], :N]
    return out.reshape(*lead, N).to(x.dtype)


def dpa_matmul_prequant_pipeline(x, prep: dict, policy, *, bm=128, bk=128):
    """Prequant pipeline: a plain quantize pass over x (per-row scales over
    the whole K), codes padded and, on an fp4 side of a packed policy,
    nibble-packed along K; `prep` holds the load-time weights.  Pads,
    slices and casts like the reference."""
    policy = get_policy(policy)
    lead, K, N = x.shape[:-1], x.shape[-1], prep["n"]
    x2 = x.reshape(-1, K)
    xq, sx, pack_x = _quant_acts(x2, policy, min(bm, max(8, x2.shape[0])),
                                 bk, 0)
    out = _dm.dpa_matmul_prequant(
        xq, prep["wq"], sx, prep["sw"], fmt_x=policy.fmt_acts,
        fmt_w=policy.fmt_weights, pack_x=pack_x, pack_w=prep["pack_w"])
    out = out[: x2.shape[0], :N]
    return out.reshape(*lead, N).to(x.dtype)


def _quant_acts(x, policy, bm_, bk, m_dim):
    """Row-quantize x (..., M, K) over K, pad M to bm_ (codes and scales)
    and K to bk, pack fp4 codes along K when the policy packs."""
    pack_x = policy.packed and policy.fmt_acts == "fp4_e2m1"
    xq, sx = _quant_operand(x, policy.fmt_acts, -1)
    xq, _ = _pad_to(xq, bm_, m_dim)
    sx, _ = _pad_to(sx, bm_, m_dim)
    xq, _ = _pad_to(xq, bk, m_dim + 1)
    if pack_x:
        xq = pack_fp4_axis(xq, m_dim + 1)
    return xq.contiguous(), sx.contiguous(), pack_x


def grouped_views(eq: str, x):
    """A known grouped einsum as stacked per-expert matmuls: -> (x3 (E, M,
    K), unview: (E, M, N) -> eq's output).  "becd,edf->becf" folds the
    batch into each expert's rows (M = B * C)."""
    if eq == "gti,gio->gto":
        return x, lambda o: o
    if eq == "becd,edf->becf":
        b, e, c, d = x.shape
        x3 = x.transpose(0, 1).reshape(e, b * c, d)
        return x3, lambda o: o.reshape(e, b, c, -1).transpose(0, 1)
    raise ValueError(f"unsupported grouped einsum {eq!r}")


def dpa_grouped_fused_pipeline(x, prep: dict, policy, *, eq: str, bm=128,
                               bk=128):
    """Grouped fused-quant pipeline: per-expert rows ship at native width
    and quantize in the kernel prologue; `prep` holds the load-time expert
    weights (`prep_grouped_weights`).  Per-expert M pads to
    min(bm, max(8, M)) like the reference; the result is sliced, cast to
    x's dtype and viewed back to the einsum's output."""
    policy = get_policy(policy)
    x3, unview = grouped_views(eq, x)
    M, N = x3.shape[1], prep["n"]
    x3p, _ = _pad_to(x3, min(bm, max(8, M)), 1)
    x3p, _ = _pad_to(x3p, bk, 2)
    out = _gm.dpa_grouped_matmul_fused(
        x3p.contiguous(), prep["wq"], prep["sw"], fmt_x=policy.fmt_acts,
        fmt_w=policy.fmt_weights, bk=bk, pack_w=prep["pack_w"])
    return unview(out[:, :M, :N].to(x.dtype))


def dpa_grouped_prequant_pipeline(x, prep: dict, policy, *, eq: str, bm=128,
                                  bk=128):
    """Grouped prequant pipeline: the plain quantize pass over every
    expert's rows, then the grouped prequant kernel; padding, slicing and
    the output view as in `dpa_grouped_fused_pipeline`."""
    policy = get_policy(policy)
    x3, unview = grouped_views(eq, x)
    M, N = x3.shape[1], prep["n"]
    xq, sx, pack_x = _quant_acts(x3, policy, min(bm, max(8, M)), bk, 1)
    out = _gm.dpa_grouped_matmul_prequant(
        xq, prep["wq"], sx, prep["sw"], fmt_x=policy.fmt_acts,
        fmt_w=policy.fmt_weights, pack_x=pack_x, pack_w=prep["pack_w"])
    return unview(out[:, :M, :N].to(x.dtype))


def quantize_rows(x, fmt: str, *, pack: bool = False):
    """Row quantization of a 2-D x: -> (codes, (M, 1) f32 scales); with
    `pack` (fp4 only) the E2M1 codes come two per byte, (M, K // 2).
    Resolved through `core.exec_plan` op ``quantize_pack``.  The CUDA
    kernel takes any row count, so the reference's `bm` row tile (and its
    padding of rows to it) has no counterpart here."""
    entry = exec_plan.resolve("quantize_pack", None, fmt=fmt, pack=pack)
    return entry.run(x, fmt=fmt, pack=pack)
