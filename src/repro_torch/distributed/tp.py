"""Tensor-parallel serving context: the group the sharded routes read
(port of `repro.distributed.tp`).

The reference engine shards its paged KV pool across a "model" mesh axis
and traces its steps under that mesh.  The port runs one process per
rank (`launch.mesh`): every rank runs the same scheduler on the same
requests, holds 1/tp of the pool (rows [r * page / tp, (r + 1) * page /
tp) of every page: `distributed.sharding.cache_placement`), and
`torch.distributed` collectives take the place of `all_gather`, `pmax`
and `psum`.  The engine activates its group here around every step, and
the registry's sharded routes and `models.layers` read it back.

Bit-identity contract: the sharded routes all-gather the local pool
shards (format-width codes and per-row f32 scales: a pure relayout, and
the narrow wire the paper prices) and then run the single-device route
on the reassembled pool.  No cross-rank float reduction touches the
softmax, so sharded greedy outputs equal tp=1's bit for bit.

The wire: gloo refuses float8 tensors, so narrow codes travel as their
bytes (`.view(torch.uint8)`) and are viewed back on landing; f32 scales
travel as f32.  Whether a collective takes the rank's CUDA tensors or
stages them through host memory is fixed per backend
(`STAGES_THROUGH_HOST`: gloo stages, NCCL does not), stated in the
engine's report, and never chosen on failure.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

# pool leaves that travel on the wire (codes + per-row scales; the block
# table and the positions are host-driven metadata every rank holds)
POOL_WIRE_KEYS = ("k_codes", "k_scale", "v_codes", "v_scale")

# per backend: does a collective on CUDA tensors copy them to host memory
# first?  PyTorch documents gloo on the GPU for all_reduce and broadcast
# only, so gloo always stages; NCCL takes device tensors.
STAGES_THROUGH_HOST = {"gloo": True, "nccl": False}
# staged tensors of at least this many bytes go through pinned host
# buffers, smaller ones through pageable memory: on an H100 two gloo ranks
# took 11.0 s for a step's 5.3 GB of f32 gradients pinned against 16.8 s
# pageable, while a decode step's 144 pool shards of <= 330 KB took 830
# ms pinned against 440 ms pageable (PERF.md §6, PR 30)
PIN_MIN_BYTES = 1 << 20

_ACTIVE_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_tp_group", default=None)


@contextlib.contextmanager
def activate(group):
    """Make `group` the one the sharded routes read inside (None: no
    group, every route single-device)."""
    tok = _ACTIVE_GROUP.set(group)
    try:
        yield group
    finally:
        _ACTIVE_GROUP.reset(tok)


def active_group():
    return _ACTIVE_GROUP.get()


def axis_size() -> int:
    """Ranks in the active group (1 when none is active)."""
    group = _ACTIVE_GROUP.get()
    return 1 if group is None else dist.get_world_size(group)


def shard() -> tuple:
    """(this rank, ranks) in the active group; (0, 1) when none."""
    group = _ACTIVE_GROUP.get()
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def require_group():
    group = _ACTIVE_GROUP.get()
    if group is None:
        raise RuntimeError(
            "sharded exec-plan route resolved without an active TP group; "
            "wrap the call in repro_torch.distributed.tp.activate(group) "
            "(launch/engine.py does this around every step)")
    return group


def stages_through_host(group) -> bool:
    """True when `group`'s collectives copy CUDA tensors through host
    memory (`STAGES_THROUGH_HOST`, by the group's backend)."""
    backend = str(dist.get_backend(group))
    if backend not in STAGES_THROUGH_HOST:
        raise ValueError(f"no wire rule for backend {backend!r}")
    return STAGES_THROUGH_HOST[backend]


def _to_wire(x):
    """A tensor as the collective carries it: f32 and integer tensors as
    they are, anything narrower as its bytes along the last dim."""
    x = x.contiguous()
    if x.dtype in (torch.float32, torch.uint8, torch.int32, torch.int64):
        return x
    return x.view(torch.uint8)


def _pinned(t) -> bool:
    return t.numel() * t.element_size() >= PIN_MIN_BYTES


def _host(t):
    """A host copy of CUDA tensor t, pinned from `PIN_MIN_BYTES` on
    (torch's caching host allocator keeps the pinned buffers)."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=_pinned(t))
    out.copy_(t)
    return out


def all_gather(x, group) -> list:
    """[rank 0's x, rank 1's x, ...] on x's device, bit for bit: narrow
    dtypes travel as bytes, and under a staging backend CUDA tensors go
    through host memory (`_host`)."""
    shape = x.shape
    wire = _to_wire(x.reshape(1) if x.ndim == 0 else x)
    stage = wire.device.type == "cuda" and stages_through_host(group)
    send = _host(wire) if stage else wire
    parts = [torch.empty(send.shape, dtype=send.dtype, device=send.device,
                         pin_memory=stage and _pinned(send))
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, send, group=group)
    if stage:
        parts = [p.to(x.device) for p in parts]
    return [(p.view(x.dtype) if p.dtype != x.dtype else p).reshape(shape)
            for p in parts]


def all_reduce(x, op, group):
    """`dist.all_reduce(x, op)` in place on f32 x, staged through host
    memory where the backend says so; -> x."""
    if x.device.type == "cuda" and stages_through_host(group):
        host = _host(x)
        dist.all_reduce(host, op=op, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, op=op, group=group)
    return x


def ordered_sum(parts):
    """parts[0] + parts[1] + ... in rank order, so every rank that holds
    the same parts gets the same bits."""
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total


def psum(x, group):
    """The sum of x over the group, every rank's x summed in rank order
    (all-gather at x's width, then `ordered_sum`): the same bits on every
    rank, which `all_reduce(SUM)` does not promise."""
    return ordered_sum(all_gather(x, group))


def agree(value: float, group) -> float:
    """Rank 0's `value` on every rank (a broadcast): what the ranks of a
    lockstep scheduler must decide alike, such as the clock an open-loop
    workload's arrivals are read against."""
    dev = ("cuda" if str(dist.get_backend(group)) == "nccl" else "cpu")
    t = torch.tensor([value], dtype=torch.float64, device=dev)
    dist.broadcast(t, src=dist.get_global_rank(group, 0), group=group)
    return float(t.item())


def _gather_pool(shards: dict, group) -> dict:
    """All-gather the pool shards back into the full pool.

    The wire moves format-width codes and per-row f32 scales, never
    dequantized rows, and the all-gather is tiled along the within-page
    row axis (axis 1), so it is a pure relayout: the reassembled pool is
    bit-identical to the unsharded one."""
    return {key: torch.cat(all_gather(x, group), dim=1)
            for key, x in shards.items()}


def sharded_paged_attn(attn_fn, q, cache, positions):
    """Run a paged-attention fn over the pool sharded on the active group.

    `attn_fn(q, cache, positions)` is the exact single-device route body;
    the wrapper changes only where the pool bytes live (1/n per rank) and
    what the wire carries (codes + scales)."""
    group = require_group()
    full = _gather_pool({k: cache[k] for k in POOL_WIRE_KEYS}, group)
    full["block_table"] = cache["block_table"]
    return attn_fn(q, full, positions)


def psum_wire(x, group, fmt_name: str = "fp8_e4m3"):
    """Sum over the group with a format-width wire and f32 accumulation:
    each rank ships its partial at `fmt_name` width plus one f32 scale,
    and every rank sums the widened partials in rank order.  Lossy at the
    wire format's precision: serving's pure-relayout routes never use
    it; it is for row- or column-parallel partials and gradients."""
    from repro_torch.distributed.collectives import (dequantize_from_wire,
                                                     quantize_for_wire)
    q, scale = quantize_for_wire(x, fmt_name)
    qs, ss = all_gather(q, group), all_gather(scale, group)
    return ordered_sum([dequantize_from_wire(p, s, fmt_name)
                        for p, s in zip(qs, ss)])


def all_gather_wire(x, group, fmt_name: str = "fp8_e4m3", *,
                    gather_axis: int = 0):
    """Tiled all-gather with a format-width wire: quantize the local
    shard, gather codes and per-shard scales, dequantize each slab on
    landing.  Tensors that are already codes (the KV pool) take
    `all_gather`, whose wire is already format width and exact."""
    from repro_torch.distributed.collectives import (dequantize_from_wire,
                                                     quantize_for_wire)
    q, scale = quantize_for_wire(x, fmt_name)
    qs, ss = all_gather(q, group), all_gather(scale, group)
    return torch.cat([dequantize_from_wire(p, s, fmt_name)
                      for p, s in zip(qs, ss)], dim=gather_axis)
