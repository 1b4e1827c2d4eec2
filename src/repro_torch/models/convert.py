"""Convert the reference's params into the port's.

The port's own init draws other weights than JAX's (its normal draws
pass through transcendentals whose last bits differ), so the tests move
weights across: `jax.tree.map(np.asarray, params)` on the JAX side, then
`convert_params` here.  The reference stacks per-layer params on a
leading scan axis (`stack.groups.p0`, plus an unscanned tail); the port
keeps a per-layer list.  A MoE block's router and (E, d_in, d_out)
expert stacks cross like any other leaf, as f32 masters.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def convert_params(np_params: dict, model) -> dict:
    """Nested dict of numpy arrays (the reference's decoder or MoE params)
    -> the port's prepared params on the model's device."""
    dev = model.device
    stack = np_params["stack"]
    groups = stack["groups"]
    if set(groups) != {"p0"}:
        raise ValueError(f"decoder stacks have one pattern slot, got "
                         f"{sorted(groups)}")
    g = groups["p0"]
    n_groups = np.asarray(g["norm1"]["scale"]).shape[0]
    layers = [_tree(g, lambda a, i=i: _tensor(np.asarray(a)[i], dev))
              for i in range(n_groups)]
    layers += [_tree(t, lambda a: _tensor(a, dev)) for t in stack["tail"]]
    if len(layers) != model.cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a "
                         f"{model.cfg.n_layers}-layer config")
    params = {"layers": layers,
              "norm_f": _tree(np_params["norm_f"], lambda a: _tensor(a, dev)),
              "embed": _tree(np_params["embed"], lambda a: _tensor(a, dev))}
    return model.prepare_params(params)
