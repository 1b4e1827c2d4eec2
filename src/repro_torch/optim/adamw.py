"""AdamW over f32 master weights, with the warmup-then-decay schedules and
the global-norm clip (port of `repro.optim.adamw`).

The state is {"m", "v", "count"}: m and v mirror the param tree in f32,
count is a 0-dim int32 tensor.  `update` writes params, m, v and count
in place (the counterpart of the reference's donated jitted step) and
returns the same objects, so a train step holds one copy of the state.

Operation order is the reference's: clip, then m1, v1, the bias
corrections 1 - b^count, step + wd * p, p - lr * step, each leaf in f32.
Under `jax.jit` XLA turns a division by a constant into a multiply by
the f32 reciprocal (ROADMAP Queue 3, F1), so the schedule does too
(`recip`); divisions by computed values stay IEEE divisions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.quantize import recip
from repro_torch.core.tree import leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"         # cosine | linear | constant
    min_lr_ratio: float = 0.1


def _f32(x, device):
    return torch.tensor(x, dtype=F32, device=device)


def lr_at(cfg: AdamWConfig, step, device=None):
    """The learning rate at `step` (an int or an integer tensor) -> 0-dim
    f32 tensor: linear warmup over `warmup_steps`, then the schedule's
    decay to `min_lr_ratio` at `total_steps`."""
    if torch.is_tensor(step):
        step = step.to(F32)
    else:
        step = _f32(float(step), device)
    warm = torch.clamp_max((step + 1) * recip(max(cfg.warmup_steps, 1)),
                           1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    * recip(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 \
            * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        decay = 1.0
    return cfg.lr * warm * decay


def init(params) -> dict:
    """Zero moments in f32 beside every param leaf, count 0."""
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    dev = leaves(params)[0].device
    return {"m": zeros,
            "v": tree_map(torch.zeros_like, zeros),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree):
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    total = 0
    for x in leaves(tree):
        xf = x.to(F32)
        total = total + (xf * xf).sum()
    return torch.sqrt(total)


def _clip_scale(norm, max_norm):
    # max_norm / norm as one IEEE division (a Python number over a tensor
    # would take the reciprocal first)
    return torch.clamp_max(_f32(max_norm, norm.device)
                           / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(grads, max_norm):
    """-> (grads scaled to a global norm of at most max_norm, in f32; the
    norm before clipping)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(F32) * scale, grads), norm


@torch.no_grad()
def update(cfg: AdamWConfig, grads, opt_state, params, decay):
    """One AdamW step, in place -> (params, opt_state, {"grad_norm",
    "lr"}).  Weight decay applies to the leaves `decay` (a tree of bools
    in params' structure) marks: a model passes `Model.decay_mask`, the
    reference's choice in its stacked layout.  The clipped gradient is
    formed one leaf at a time (the same values as
    `clip_by_global_norm`'s tree)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    count = opt_state["count"]
    lr = lr_at(cfg, count)
    cf = (count + 1).to(F32)
    bc1 = 1.0 - torch.pow(cfg.b1, cf)
    bc2 = 1.0 - torch.pow(cfg.b2, cf)
    for p, g, m, v, dk in zip(leaves(params), leaves(grads),
                              leaves(opt_state["m"]),
                              leaves(opt_state["v"]), leaves(decay)):
        g = g.to(F32) * scale
        m1 = cfg.b1 * m + (1 - cfg.b1) * g
        v1 = cfg.b2 * v + (1 - cfg.b2) * (g * g)
        step = (m1 / bc1) / (torch.sqrt(v1 / bc2) + cfg.eps)
        pf = p.to(F32)
        step = step + cfg.weight_decay * (1.0 if dk else 0.0) * pf
        p.copy_((pf - lr * step).to(p.dtype))
        m.copy_(m1)
        v.copy_(v1)
    count.add_(1)
    return params, opt_state, {"grad_norm": norm, "lr": lr}
