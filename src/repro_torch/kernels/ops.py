"""Public wrappers around the kernels: policy-level padding, slicing and
weight preparation (port of `repro.kernels.ops`).

The reference quantizes the f32 master weights again on every call
(`ops.py:_prep_weights`).  The port quantizes, pads and packs them once,
at load (`prep_weights`), with the same numerics — per-column scale by
`compute_scale(dim=0)`, `encode_fp4(clip(w / scale, +-6))`, nibble pack
along K — and keeps `wq`/`sw` on the device beside the master weight.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.packing import pack_fp4_axis
from repro_torch.core.policy import get_policy
from repro_torch.core.quantize import cast_to, compute_scale, encode_fp4
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
    policy = get_policy(policy)
    pack_w = policy.packed and policy.fmt_weights == "fp4_e2m1"
    wq, sw = _quant_operand(w, policy.fmt_weights, 0)
    wq, _ = _pad_to(wq, bk, 0)
    wq, _ = _pad_to(wq, bn, 1)
    swp, _ = _pad_to(sw, bn, 1)
    if pack_w:
        wq = pack_fp4_axis(wq, 0)
    return {"wq": wq.contiguous(), "sw": swp.contiguous(),
            "n": int(w.shape[1]), "pack_w": pack_w}


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
