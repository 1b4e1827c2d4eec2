"""Token sampling (port of `repro.serving.sampler`, greedy mode).

Sampled mode draws from per-request JAX threefry streams, which torch
cannot reproduce; it joins the port later (ROADMAP Queue 1, "Sampled
decoding and the serving front end").  The
greedy path is the engine's anchor: raw-logits argmax with NaN logits
masked, bit-identical to a plain argmax on NaN-free rows, and token 0 for
an all-NaN row.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling knobs; temperature 0 is greedy, the only mode served
    (top-k, top-p and the stream seed arrive with sampled mode)."""
    temperature: float = 0.0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def greedy_tokens(logits):
    """Argmax with NaN logits masked: (..., V) -> (...) int32.  Ties take
    the first index, as jnp.argmax does."""
    x = torch.where(torch.isnan(logits), float("-inf"), logits)
    return torch.argmax(x, dim=-1).to(torch.int32)
