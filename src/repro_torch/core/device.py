"""Device selection and the row-invariant f32 product.

Entry points (`build_model`, `Engine`, `generate`) run on the card unless
the caller asks for the CPU; `resolve_device` is the one place that
decides, and it also pins full-f32 matmuls on the card (the f32 routes
assume no TF32).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` or "cuda"; raises when CUDA is asked for and absent."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch entry points run on the card; "
                "pass device='cpu' to run the plain PyTorch paths")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


# elements of the broadcast product one `rowwise_dot` slice materializes
_SLICE_ELEMS = 1 << 25


def rowwise_dot(a, bt):
    """f32 a (..., K) . bt (N, K) -> (..., N): out[..., n] = sum_k a[..., k]
    * bt[n, k], each output summed over K in one fixed order.

    A BLAS GEMM picks its kernel by shape (a gemv for one row, a blocked
    gemm for several), so row i of an (M, K) product can differ in the
    last bit from the same row computed alone.  The engine's outputs are
    pinned token for token against a batch-of-one path, so the plain
    paths take this form instead: an elementwise product reduced over the
    contiguous last dim, which treats every row alike whatever M is.
    Slices over rows and columns bound the temporary; slicing does not
    change any output's sum order.

    On the card the product is cuBLAS's full-f32 GEMM (TF32 off): CUDA
    reductions are not row-invariant either, the elementwise form would
    cost ~100x more there, and the card's engine-vs-`generate` agreement
    is reported rather than pinned."""
    if a.device.type == "cuda":
        return torch.matmul(a.to(torch.float32), bt.to(torch.float32).t())
    lead, K = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, K).to(torch.float32)
    bt = bt.to(torch.float32).contiguous()
    M, N = a2.shape[0], bt.shape[0]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    cols = max(1, min(N, _SLICE_ELEMS // K))
    rows = max(1, _SLICE_ELEMS // (K * cols))
    for i in range(0, M, rows):
        for j in range(0, N, cols):
            out[i:i + rows, j:j + cols] = (
                a2[i:i + rows, None, :] * bt[None, j:j + cols]).sum(-1)
    return out.reshape(*lead, N)


def batched_rowwise_dot(a, b):
    """f32 a (*batch, S, K) . b (*batch, T, K) -> (*batch, S, T), each
    output summed over K in one fixed order (`rowwise_dot`'s contract per
    batch element, sliced over S to bound the temporary; a batched GEMM on
    the card)."""
    if a.device.type == "cuda":
        return torch.matmul(a.to(torch.float32),
                            b.to(torch.float32).transpose(-1, -2))
    a = a.to(torch.float32)
    b = b.to(torch.float32).contiguous()
    S, T = a.shape[-2], b.shape[-2]
    # one query row materializes batch * T * K products, i.e. b.numel()
    rows = max(1, _SLICE_ELEMS // max(1, b.numel()))
    out = torch.empty(a.shape[:-1] + (T,), dtype=torch.float32,
                      device=a.device)
    for i in range(0, S, rows):
        out[..., i:i + rows, :] = (
            a[..., i:i + rows, None, :] * b[..., None, :, :]).sum(-1)
    return out


def by_query_row(fn, *xs, dim: int = 1, rows: int = 1):
    """fn over the tensors xs split alike along `dim` into slices of
    `rows` (the last may be shorter), each made contiguous, the outputs
    concatenated along `dim` (each of them where fn returns a tuple).
    The speculative verify pass's rows (x (B, S_q, ...), dim 1, rows 1):
    each call sees the decode step's shape, (B, 1, ...), so a kernel or a
    cuBLAS GEMM that picks its order by the number of rows gives each
    query row the decode step's bits."""
    parts = zip(*(x.split(rows, dim=dim) for x in xs))
    outs = [fn(*(s.contiguous() for s in p)) for p in parts]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o, dim=dim) for o in zip(*outs))
    return torch.cat(outs, dim=dim)
