"""Placement rules: which dim of a tensor lies on which group axis (the
cache half of `repro.distributed.sharding`).

The reference returns JAX `NamedSharding`s over a mesh; the port's
ranks each hold their own slice, so a placement here is a tuple with one
entry per dim: an axis name, a tuple of axis names, or None
(replicated).  `take_shard` cuts a rank's slice by it.  Only the rules
this slice serves with are here: the divisibility guard and the KV cache
rule; the parameter and batch rules come with model-parallel serving and
training (ROADMAP Queue 1, "Model-parallel serving and training
(`--n-model`)").
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.tree import tree_map_with_path

MODEL_AXIS = "model"
DATA_AXES = ("data",)
KV_LEAVES = ("k", "v", "k_codes", "v_codes", "k_scale", "v_scale")


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(sizes.get(a, 1) for a in axis)
    return sizes.get(axis, 1)


def _guard(spec, shape, sizes: dict) -> tuple:
    """Shard each dim by the longest prefix of its axis group that divides
    it; a single axis that does not divide its dim replicates it (the
    reference's `_guard`, over axis sizes in place of a mesh)."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None or dim % _axis_size(sizes, ax) == 0:
            out.append(ax)
            continue
        pick = None
        if isinstance(ax, tuple):
            for k in range(len(ax) - 1, 0, -1):
                if dim % _axis_size(sizes, ax[:k]) == 0:
                    pick = ax[:k] if k > 1 else ax[0]
                    break
        out.append(pick)
    return tuple(out) + (None,) * (len(shape) - len(out))


def cache_placement(cache_tree, sizes: dict, data_axes=DATA_AXES):
    """KV leaves (B, S, KV, width): batch on the data axes, sequence on
    "model".  Quantized caches place the same way: codes and their
    per-row scales carry the sequence on dim 1, and they move together,
    or a rank would hold codes it cannot dequantize.  In the paged pool
    (P, page, KV, width) dim 1 is the within-page row, so a rank holds a
    slice of every page.  Other leaves (block tables, recurrent states):
    batch on the data axes, the rest replicated.  -> a tree of
    placements, guarded against `sizes`."""
    da = data_axes[0] if len(data_axes) == 1 else tuple(data_axes)

    def place(path, leaf):
        if not torch.is_tensor(leaf) or leaf.ndim == 0:
            return ()
        if path and path[-1] in KV_LEAVES and leaf.ndim == 4:
            spec = (da, MODEL_AXIS, None, None)
        else:
            spec = (da,) + (None,) * (leaf.ndim - 1)
        return _guard(spec, tuple(leaf.shape), sizes)

    return tree_map_with_path(place, cache_tree)


def take_shard(x, placement, coords: dict, sizes: dict):
    """The slice of `x` the rank at `coords` ({axis: index}) holds under
    `placement`, as a contiguous copy."""
    for dim, ax in enumerate(placement):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        n, idx = 1, 0
        for a in axes:
            idx = idx * sizes.get(a, 1) + coords.get(a, 0)
            n *= sizes.get(a, 1)
        if n > 1:
            step = x.shape[dim] // n
            x = x.narrow(dim, idx * step, step)
    return x.contiguous().clone()


def shard_seq_caches(model, caches, group):
    """The rank's slice of a model's caches (`Model.init_caches`) for
    flash decoding (`models.decode_attn.flash_decode`): each full
    attention layer's raw (B, S, KV, hd) K and V (not a local layer's
    window, nor a quantized cache) keep the sequence
    positions the rank holds under `cache_placement`, and the layer's
    dict is marked "seq_shard": (rank, ranks).  Where S does not divide
    by the group's size the layer stays whole and unmarked, and decodes
    on the plain path, as the reference's gate falls back."""
    import torch.distributed as dist
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    sizes, coords = {MODEL_AXIS: n}, {MODEL_AXIS: rank}
    out = []
    for kind, cache in zip(model.kinds, caches):
        if kind not in ("attn", "dec") or set(cache) != {"k", "v"}:
            out.append(cache)
            continue
        place = cache_placement(cache, sizes)
        if place["k"][1] != MODEL_AXIS:
            out.append(cache)
            continue
        out.append({"k": take_shard(cache["k"], place["k"], coords, sizes),
                    "v": take_shard(cache["v"], place["v"], coords, sizes),
                    "seq_shard": (rank, n)})
    return out
