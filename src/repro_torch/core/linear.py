"""DPALinear — every matmul of the port goes through here (port of
`repro.core.linear`).

Forward contract (Table I): y = sum_k q(x)_k * q(w)_k with products in
the operand format and accumulation in f32.  Which route serves a call —
the f32 product, STE fake-quant, or a CUDA kernel (fused-quant or
prequant) — is the execution plan's decision
(`exec_plan.resolve("matmul" | "grouped_matmul", ...)`).

A linear's params are a dict: {"w": (d_in, d_out) f32 master weight}
plus, for the kernel policies, the load-time serving weights that
`prepare_linear` adds ({"wq", "sw", "n", "pack_w"}, see
`kernels.ops.prep_weights`).  A grouped (MoE expert) linear is the same
with an (E, d_in, d_out) stack (`prepare_grouped_linear`).
"""
from __future__ import annotations

import torch

from . import exec_plan
from .policy import get_policy


def init_linear(generator, d_in: int, d_out: int, *, bias: bool = False,
                device="cpu"):
    """normal * d_in^-0.5, f32 — the reference init's shapes and scale;
    with `bias`, a zero (d_out,) "b"."""
    w = torch.randn((d_in, d_out), generator=generator, dtype=torch.float32,
                    device=device) * d_in ** -0.5
    if bias:
        return {"w": w, "b": torch.zeros((d_out,), dtype=torch.float32,
                                         device=device)}
    return {"w": w}


# grouped einsums the grouped kernel routes understand as a stack of
# per-expert (M, K) x (K, N) products (the registry predicates gate on it)
GROUPED_EQS = ("gti,gio->gto", "becd,edf->becf")

# the kernel routes, which consume load-time quantized weights
_PREP_ROUTES = {"matmul": ("cuda_fused", "cuda_prequant"),
                "grouped_matmul": ("cuda_grouped_fused",
                                   "cuda_grouped_prequant")}


def needs_prep(policy, op: str = "matmul") -> bool:
    """True when the policy's linears (`op` "matmul") or expert stacks
    ("grouped_matmul") route to a kernel that consumes load-time
    quantized weights."""
    ctx = {"w_dtype": "float32"}
    if op == "grouped_matmul":
        ctx["eq"] = "becd,edf->becf"
    return exec_plan.resolve(op, get_policy(policy),
                             **ctx).name in _PREP_ROUTES[op]


def prepare_linear(params: dict, policy, compute_dtype) -> dict:
    """Add the kernels' serving weights to one linear's params.

    The reference's `apply_linear` casts the master weight to the
    activation dtype before the matmul quantizes it, so the load-time
    prep quantizes `w.to(compute_dtype)`, not the f32 master."""
    from repro_torch.kernels.ops import prep_weights
    params.update(prep_weights(params["w"].to(compute_dtype), policy))
    return params


def dpa_dot(x, lin: dict, policy, *, per_row: bool = False):
    """The DPA execution contract for x @ lin["w"].  `per_row` (x (B,
    S_q, K), the speculative verify pass on the card): the product runs
    one query row at a time at the decode step's shape where the route's
    row bits depend on the number of rows (`kernels.registry`)."""
    policy = get_policy(policy)
    w = lin["w"]
    entry = exec_plan.resolve("matmul", policy,
                              w_dtype=str(w.dtype).replace("torch.", ""),
                              m=x.numel() // x.shape[-1], k=x.shape[-1],
                              n=w.shape[-1])
    return entry.run(x, lin, policy, per_row=per_row)


def apply_linear(params, x, policy=None, *, per_row: bool = False):
    policy = get_policy(policy or "fp32")
    if params["w"].dtype == torch.uint8:
        raise TypeError(
            "apply_linear got uint8 code weights; keep the float master "
            "weight in params['w'] (the fused policies add their codes "
            "beside it)")
    y = dpa_dot(x, params, policy, per_row=per_row)
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# grouped (expert) linear for MoE: contraction per expert
# ---------------------------------------------------------------------------

def init_grouped_linear(generator, n_groups: int, d_in: int, d_out: int, *,
                        device="cpu"):
    """normal * d_in^-0.5, f32, (n_groups, d_in, d_out)."""
    w = torch.randn((n_groups, d_in, d_out), generator=generator,
                    dtype=torch.float32, device=device) * d_in ** -0.5
    return {"w": w}


def prepare_grouped_linear(params: dict, policy) -> dict:
    """Add the grouped kernel's serving weights to one expert stack.

    Unlike `prepare_linear`, this quantizes the f32 master itself: the
    reference's `apply_moe` passes the expert weights to the grouped
    route uncast, and its `_prep_grouped_weights` quantizes them as they
    are.  (At bf16 the two differ wherever the bf16 rounding moves a
    value across a code boundary.)"""
    from repro_torch.kernels.ops import prep_grouped_weights
    params.update(prep_grouped_weights(params["w"], policy))
    return params


def grouped_dims(eq: str, x_shape, w_shape):
    """(experts, per-expert M, K, N) for a known grouped einsum, else
    None.  "becd,edf->becf" folds the batch into per-expert rows."""
    if eq == "gti,gio->gto":
        return x_shape[0], x_shape[1], x_shape[2], w_shape[2]
    if eq == "becd,edf->becf":
        b, e, c, d = x_shape
        return e, b * c, d, w_shape[2]
    return None


def dpa_grouped_dot(x, lin: dict, policy, *, eq: str,
                    per_row: bool = False):
    """The grouped (per-expert) DPA contract: einsum `eq` over x and the
    stacked expert weights lin["w"], routed through the plan layer.
    `per_row`: the verify pass, as in `dpa_dot` (the rows lie along
    `kernels.ops.GROUPED_ROW_DIM[eq]`)."""
    policy = get_policy(policy)
    w = lin["w"]
    dims = grouped_dims(eq, tuple(x.shape), tuple(w.shape))
    ctx = {} if dims is None else dict(zip(("e", "m", "k", "n"),
                                           map(int, dims)))
    entry = exec_plan.resolve("grouped_matmul", policy,
                              w_dtype=str(w.dtype).replace("torch.", ""),
                              eq=eq, **ctx)
    return entry.run(x, lin, policy, eq=eq, per_row=per_row)


def apply_grouped_linear(params, x, policy=None):
    """x: (n_groups, tokens, d_in) -> (n_groups, tokens, d_out)."""
    return dpa_grouped_dot(x, params, get_policy(policy or "fp32"),
                           eq="gti,gio->gto")
