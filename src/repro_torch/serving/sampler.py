"""Fixed-shape token sampling with per-request threefry streams (port of
`repro.serving.sampler`).

A request's tokens must not depend on which other requests share its
batch, so randomness is derived per request, never per batch: the stream
for one sampled token is

    fold_in(fold_in(fold_in(PRNGKey(seed), rid), position), role)

keyed on the request id and the token's absolute timeline index.  The
port computes it with its own copy of JAX's threefry arithmetic
(`serving.threefry`), so the keys, bits and uniforms are the reference's
own, bit for bit.  `role` separates the independent uses speculative
decoding makes of one position.

Every transform is fixed-shape over the full vocab and all tensor ops,
with no branch on data and no host generator, so the sampler runs inside
a captured decode step (`launch.graphs`).  ``temperature == 0`` is
`greedy_tokens`, the raw-logits argmax the greedy engine ran.

Temperature scaling multiplies by the f32 reciprocal of the temperature,
as `jax.jit` compiles the reference's division by a constant.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving import threefry as TF

# role salts: independent streams at one (rid, position)
ROLE_SAMPLE = 0      # plain decode sampling
ROLE_DRAFT = 1       # speculative proposal draw
ROLE_ACCEPT = 2      # accept/reject uniform
ROLE_RESIDUAL = 3    # residual / bonus draw after the accept decision

_NEG = float("-inf")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Sampling knobs.  Temperature 0 means greedy (argmax over raw
    logits); top_k 0 and top_p 1.0 disable those filters (`top_k >= vocab`
    keeps every token too); `seed` roots every request's stream."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def request_key(seed: int, rid, position, role: int, device=None):
    """The per-token threefry key: (seed, rid, position, role) folds.
    `rid` and `position` may be ints or integer tensors (broadcast
    together: one key per slot) -> (..., 2) int64 key words.  Folds of
    ints stay on the host, so a captured step copies nothing in."""
    k1, k2 = 0, int(seed) & TF.MASK            # PRNGKey(seed), 32-bit JAX
    for data in (rid, position, role):
        k1, k2 = TF.fold_words(k1, k2, data)
    return TF.key_tensor(k1, k2, device)


def greedy_tokens(logits):
    """Argmax with NaN logits masked: (..., V) -> (...) int32.  Ties take
    the first index, as jnp.argmax does."""
    x = torch.where(torch.isnan(logits), _NEG, logits)
    return torch.argmax(x, dim=-1).to(torch.int32)


def filter_logits(logits, cfg: SamplerConfig):
    """Raw logits (..., V) -> f32 filtered and scaled logits, the
    reference's rule: NaN entries masked (-inf); an all-masked row keeps
    token 0 at 0; temperature scaling; top-k keeps every value >= the
    k-th largest (ties at the k-th all kept; ``k >= V`` disables); top-p
    keeps tokens while the mass strictly before them (sorted descending)
    is < p, so p exactly on a cumulative step cuts the boundary token.
    At least one token always survives."""
    x = logits.to(torch.float32)
    x = torch.where(torch.isnan(x), _NEG, x)
    dead = ~torch.any(x > _NEG, dim=-1, keepdim=True)
    first = torch.arange(x.shape[-1], device=x.device) == 0
    x = torch.where(dead & first, 0.0, x)
    if cfg.temperature > 0:
        x = x * float(np.float32(1.0) / np.float32(cfg.temperature))
    if 0 < cfg.top_k < x.shape[-1]:
        # the k-th largest value: sort(x)[..., -k], by selection
        kth = torch.topk(x, cfg.top_k, dim=-1).values[..., -1:]
        x = torch.where(x < kth, _NEG, x)
    if cfg.top_p < 1.0:
        p = torch.softmax(x, dim=-1)
        sp = torch.sort(p, dim=-1, descending=True).values
        mass_before = torch.cumsum(sp, dim=-1) - sp
        keep = mass_before < cfg.top_p
        # the smallest kept probability (the largest is always kept)
        thr = torch.amin(torch.where(keep, sp, float("inf")), dim=-1,
                         keepdim=True)
        x = torch.where(p < thr, _NEG, x)
    return x


def sample_probs(logits, cfg: SamplerConfig):
    """The sampling distribution: softmax of the filtered logits (zeros
    at masked slots)."""
    return torch.softmax(filter_logits(logits, cfg), dim=-1)


def sample_tokens(logits, rids, positions, cfg: SamplerConfig,
                  role: int = ROLE_SAMPLE):
    """Batched per-request draw: logits (B, V), rids / positions (B,)
    integer tensors -> (B,) int32 tokens.  Greedy configs take the argmax
    (no stream drawn); otherwise one categorical per row under its
    request key."""
    if cfg.greedy:
        return greedy_tokens(logits)
    keys = request_key(cfg.seed, rids, positions, role)
    x = filter_logits(logits, cfg)
    return TF.categorical(keys, x).to(torch.int32)


def accept_uniforms(rids, positions, cfg: SamplerConfig):
    """(B,) accept/reject uniforms in [0, 1), one per request stream."""
    keys = request_key(cfg.seed, rids, positions, ROLE_ACCEPT)
    return TF.uniform(keys)


def categorical_from_probs(probs, keys):
    """(B, V) probs + (B, 2) keys -> (B,) int32 draws (log-space
    categorical; zero-probability slots are exactly excluded)."""
    logp = torch.where(probs > 0, torch.log(torch.clamp_min(probs, 1e-38)),
                       _NEG)
    return TF.categorical(keys, logp).to(torch.int32)
