"""Trans-precision collectives: the paper's DPA contract applied to the
wire between ranks (port of `repro.distributed.collectives`).

Keep the wire narrow, accumulate wide: each rank ships its gradient
partial as format-width codes plus one f32 scale, and every rank widens
the partials and sums them in f32.  Error feedback keeps the wire's
quantization bias from accumulating across steps (each round's residual
is added back before the next).

The reference reduces inside a `shard_map` body with `all_gather` and a
`jnp.mean` over the gathered axis.  Here a `torch.distributed` group
takes the axis's place, and every rank sums the widened partials in rank
order (`tp.ordered_sum`), so all ranks end with the same bits and a
replicated optimizer step stays replicated (`replicas_agree` checks it).
`CompressedReducer` carries the error-feedback state as a tree of the
rank's own residuals, so it checkpoints with the training state.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import (cast_to, compute_scale, decode_fp4,
                                       encode_fp4, recip)
from repro_torch.core.tree import flatten_with_paths, leaves, tree_map
from repro_torch.distributed import tp as TP


def quantize_for_wire(x, fmt_name: str):
    """-> (q, scale): the codes in fmt's torch dtype (uint8 E2M1 codes for
    fp4) and one f32 absmax scale, shaped (1,) * x.ndim, as the
    reference's `compute_scale` keeps dims."""
    scale = compute_scale(x, fmt_name)
    q = cast_to(x.to(torch.float32) / scale, fmt_name)
    if get_format(fmt_name).name == "fp4_e2m1":
        q = encode_fp4(q)
    return q, scale


def dequantize_from_wire(q, scale, fmt_name: str = None):
    """codes widened to f32 times their scale."""
    if fmt_name is not None and get_format(fmt_name).name == "fp4_e2m1":
        return decode_fp4(q) * scale
    return q.to(torch.float32) * scale


def ef_compress_allreduce(grad, err, group, fmt_name: str = "fp8_e4m3"):
    """All-reduce `grad` over `group` with a `fmt_name` wire and f32
    accumulation -> (mean grad, new err).

    Each rank quantizes grad + err; the codes and scales are all-gathered
    at format width (4x fewer bytes than f32 for fp8) and every rank sums
    the widened partials in rank order, times f32(1/n).  new err is the
    rank's own compression residual."""
    g = grad.to(torch.float32) + err
    q, scale = quantize_for_wire(g, fmt_name)
    new_err = g - dequantize_from_wire(q, scale, fmt_name)
    qs, ss = TP.all_gather(q, group), TP.all_gather(scale, group)
    total = TP.ordered_sum([dequantize_from_wire(p, s, fmt_name)
                            for p, s in zip(qs, ss)])
    return total * recip(len(qs)), new_err


def f32_allreduce_mean(grad, group):
    """The f32 wire: all-gather the partials at 4 bytes an element, sum in
    rank order, times f32(1/n) (the reference's `pmean`)."""
    parts = TP.all_gather(grad.to(torch.float32), group)
    return TP.ordered_sum(parts) * recip(len(parts))


def ef_state_like(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                    grads)


def _map_pairs(fn, grads, err_state):
    """fn(grad, err) -> (a, b) over matching leaves, in the trees' flatten
    order (the same on every rank, so their collectives pair up) ->
    (grads, err_state) with each leaf replaced by its a and b in place:
    a leaf's old tensor is let go before the next leaf's collective, so
    a full-width step holds one copy of its gradients, not two."""
    for path in [p for p, _ in flatten_with_paths(grads)]:
        node, enode = grads, err_state
        for key in path[:-1]:
            node = node[key if isinstance(node, dict) else int(key)]
            enode = enode[key if isinstance(enode, dict) else int(key)]
        leaf = path[-1] if isinstance(node, dict) else int(path[-1])
        node[leaf], enode[leaf] = fn(node[leaf], enode[leaf])
    return grads, err_state


def tree_compress_allreduce(grads, err_state, group,
                            fmt_name: str = "fp8_e4m3"):
    """Tree version: -> (mean grads, new err state): the given trees, each
    leaf replaced (`_map_pairs`)."""
    return _map_pairs(
        lambda g, e: ef_compress_allreduce(g, e, group, fmt_name), grads,
        err_state)


def wire_bytes(grads, fmt_name: str) -> int:
    """Bytes a rank ships per round on the compressed wire."""
    fmt = get_format(fmt_name)
    n = sum(g.numel() for g in leaves(grads))
    return n * fmt.bits // 8


_DIGEST_CHUNK = 1 << 24


def replicas_agree(tree, group) -> bool:
    """True when every rank holds `tree` bit for bit: each leaf's bits
    summed plainly and position-weighted in int64 (wrapping), the sums
    all-gathered and compared."""
    sums = []
    for x in leaves(tree):
        flat = x.detach().contiguous().reshape(-1)
        flat = flat.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()])
        s = torch.zeros(2, dtype=torch.int64, device=flat.device)
        for i in range(0, flat.numel(), _DIGEST_CHUNK):
            bits = flat[i:i + _DIGEST_CHUNK].to(torch.int64)
            w = torch.arange(i, i + bits.numel(), device=bits.device,
                             dtype=torch.int64) % 65521 + 1
            s += torch.stack([bits.sum(), (bits * w).sum()])
        sums.append(s)
    mine = torch.stack(sums) if sums else torch.zeros((0, 2),
                                                      dtype=torch.int64)
    return all(torch.equal(mine, other)
               for other in TP.all_gather(mine, group))


class CompressedReducer:
    """Error-feedback gradient reducer, routed through the exec plan.

    The error-feedback state is a plain tree (`init_state`) the caller
    threads through the train step, so it checkpoints with the training
    state.  Each `reduce` resolves the `allreduce` op: the
    wire-compressed route when the group has several ranks and a wire
    format is named, the f32 route otherwise."""

    def __init__(self, fmt_name: str = "fp8_e4m3"):
        self.fmt_name = fmt_name

    def init_state(self, grads):
        return ef_state_like(grads)

    def reduce(self, grads, err_state, group, *, n_devices: int):
        """-> (mean grads, new err state): the given trees, each leaf
        replaced in place (`_map_pairs`)."""
        from repro_torch.core import exec_plan
        entry = exec_plan.resolve("allreduce", None,
                                  wire_fmt=self.fmt_name,
                                  n_devices=n_devices)
        return _map_pairs(
            lambda g, e: entry.run(g, e, group=group,
                                   fmt_name=self.fmt_name), grads, err_state)
