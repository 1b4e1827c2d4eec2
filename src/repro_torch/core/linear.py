"""DPALinear — every matmul of the port goes through here (port of
`repro.core.linear`).

Forward contract (Table I): y = sum_k q(x)_k * q(w)_k with products in
the operand format and accumulation in f32.  Which route serves a call —
the f32 product, STE fake-quant, or the fused-quant CUDA kernel — is the
execution plan's decision (`exec_plan.resolve("matmul", ...)`).

A linear's params are a dict: {"w": (d_in, d_out) f32 master weight}
plus, for the fused-kernel policies, the load-time serving weights that
`prepare_linear` adds ({"wq", "sw", "n", "pack_w"}, see
`kernels.ops.prep_weights`).
"""
from __future__ import annotations

import torch

from . import exec_plan
from .policy import get_policy


def init_linear(generator, d_in: int, d_out: int, *, device="cpu"):
    """normal * d_in^-0.5, f32 — the reference init's shapes and scale."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device) * d_in ** -0.5
    return {"w": w}


def needs_prep(policy) -> bool:
    """True when the policy's linears route to the fused kernel, which
    consumes load-time quantized weights."""
    policy = get_policy(policy)
    return exec_plan.resolve("matmul", policy,
                             w_dtype="float32").name == "cuda_fused"


def prepare_linear(params: dict, policy, compute_dtype) -> dict:
    """Add the fused kernel's serving weights to one linear's params.

    The reference's `apply_linear` casts the master weight to the
    activation dtype before the matmul quantizes it, so the load-time
    prep quantizes `w.to(compute_dtype)`, not the f32 master."""
    from repro_torch.kernels.ops import prep_weights
    params.update(prep_weights(params["w"].to(compute_dtype), policy))
    return params


def dpa_dot(x, lin: dict, policy):
    """The DPA execution contract for x @ lin["w"]."""
    policy = get_policy(policy)
    w = lin["w"]
    entry = exec_plan.resolve("matmul", policy,
                              w_dtype=str(w.dtype).replace("torch.", ""),
                              m=x.numel() // x.shape[-1], k=x.shape[-1],
                              n=w.shape[-1])
    return entry.run(x, lin, policy)


def apply_linear(params, x, policy=None):
    policy = get_policy(policy or "fp32")
    if params["w"].dtype == torch.uint8:
        raise TypeError(
            "apply_linear got uint8 code weights; keep the float master "
            "weight in params['w'] (the fused policies add their codes "
            "beside it)")
    y = dpa_dot(x, params, policy)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y.to(x.dtype)
