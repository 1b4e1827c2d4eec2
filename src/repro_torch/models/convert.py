"""Convert the reference's params, train state and checkpoints into the
port's.

The port's own init draws other weights than JAX's (its normal draws
pass through transcendentals whose last bits differ), so the tests move
weights across: `jax.tree.map(np.asarray, params)` on the JAX side, then
`convert_params` here.  The reference stacks per-layer params on a
leading scan axis, one stack per pattern slot (`stack.groups.p0 ..
p{P-1}`: group g's slot i is layer g P + i), plus an unscanned tail of
n_layers mod P layers; the port keeps a per-layer list in that order.
A MoE block's router and (E, d_in, d_out) expert stacks, an RG-LRU
block's conv and lam, an xLSTM block's "mix", the QKV, GELU MLP and
LayerNorm biases, a decoder block's "norm_cross" and "cross" and an
untied model's "unembed" table cross like any other leaf, as f32
masters.  The encoder-decoder's two stacks ("enc_stack", "dec_stack",
one pattern slot each) become "enc_layers" and "dec_layers"; its
"enc_norm" and learned positions "pos_dec" cross as they are.

A train state crosses the same way (`convert_state`): the reference's
{"params", "opt": {"m", "v", "count"}}, whose m and v mirror the params.
`load_reference_checkpoint` reads a checkpoint the reference's
`runtime.checkpoint.save` wrote — `step_<N>/meta.json` and `shard_<i>.npz`,
leaves keyed by their "||"-joined paths — with numpy alone.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.tree import tree_map
from repro_torch.runtime.checkpoint import FLAT_SEP, load_flat


def _tensor(a, device, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def _unstack(stack: dict, P: int, n_layers: int, dev) -> list:
    """One reference stack of a P-slot pattern {"groups": {"p0" ..},
    "tail": [..]} -> its per-layer list of n_layers (group g's slot i is
    layer g P + i, then the tail)."""
    groups = stack["groups"]
    if set(groups) != {f"p{i}" for i in range(P)}:
        raise ValueError(f"a {P}-slot pattern, got groups {sorted(groups)}")
    n_groups = np.asarray(groups["p0"]["norm1"]["scale"]).shape[0]
    layers = [tree_map(lambda a, g=g: _tensor(np.asarray(a)[g], dev),
                       groups[f"p{i}"])
              for g in range(n_groups) for i in range(P)]
    layers += [tree_map(lambda a: _tensor(a, dev), t)
               for t in stack.get("tail", [])]
    if len(layers) != n_layers:
        raise ValueError(f"{len(layers)} layers for a {n_layers}-layer "
                         "stack")
    return layers


def convert_tree(np_params: dict, model) -> dict:
    """A tree in the reference's params structure (params, their
    gradients, or an optimizer moment), numpy leaves -> the port's
    structure of f32 tensors on the model's device, unprepared."""
    src = {"layers": "stack", "enc_layers": "enc_stack",
           "dec_layers": "dec_stack"}
    out = {key: _unstack(np_params[src[key]], len(model.pattern),
                         len(kinds), model.device)
           for key, kinds, _ in model.stacks()}
    for key, leaf in np_params.items():
        if key not in src.values():
            out[key] = tree_map(lambda a: _tensor(a, model.device), leaf)
    return out


def convert_params(np_params: dict, model) -> dict:
    """Nested dict of numpy arrays (the reference's params of a family the
    port serves) -> the port's prepared params on the model's device."""
    return model.prepare_params(convert_tree(np_params, model))


def convert_state(np_state: dict, model) -> dict:
    """The reference's train state {"params", "opt": {"m", "v", "count"}},
    numpy leaves -> the port's, on the model's device (count a 0-dim
    int32 tensor)."""
    opt = np_state["opt"]
    return {"params": convert_tree(np_state["params"], model),
            "opt": {"m": convert_tree(opt["m"], model),
                    "v": convert_tree(opt["v"], model),
                    "count": _tensor(opt["count"], model.device,
                                     np.int32).reshape(())}}


def _unflatten(flat: dict) -> dict:
    """{"a||b||0||c": leaf} -> nested dicts, a node whose keys are all
    indices becoming a list (the reference's tail of blocks)."""
    root: dict = {}
    for key, leaf in flat.items():
        node = root
        *head, last = key.split(FLAT_SEP)
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node
    return lists(root)


def load_reference_checkpoint(ckpt_dir: str, model,
                              step: Optional[int] = None):
    """A checkpoint of the reference's train state (its `checkpoint.save`
    layout) -> (the port's state on the model's device, its step); the
    latest one when step is None."""
    flat, step = load_flat(ckpt_dir, step)
    return convert_state(_unflatten(flat), model), step
