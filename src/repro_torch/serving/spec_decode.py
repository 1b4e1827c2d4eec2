"""Trans-precision self-speculative decoding: draft cheap, verify exact
(port of `repro.serving.spec_decode`).

The same weights run twice per round:

  draft  : k sequential single-token decode steps under a cheap
           low-precision policy (e.g. `w4a4_kv4_attn4`, fp4 operands on
           every product), each proposing the next token;
  verify : one batched pass under the serving policy over k+1 query
           tokens (the last accepted token and the k drafts) through the
           ``verify_attn`` route, so row i reproduces what a plain decode
           step at that position computes;
  accept : speculative rejection sampling per request, so the emitted
           distribution is exactly the serving policy's.  Greedy
           (temperature 0) is prefix-match on the argmax, so greedy
           speculative output equals the plain engine's token for token.

Both policies share the KV-cache storage format (fmt_kv / kv_packed):
draft and verify write the same page pool, and the verify pass rewrites
every row the draft phase touched with serving-policy codes.  Rows past
the accepted length hold rejected-draft values, masked by position and
rewritten by the next round; their wholly unused pages roll back to the
request's reservation (`core.kvcache.PageAllocator`).

This module owns the step pieces (draft step, accept rule), all tensor
ops with no host sync, so both run inside captured steps
(`launch.graphs`); the scheduler side lives in `launch.engine`.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import get_policy

from . import sampler as S
from .sampler import SamplerConfig


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculation knobs.  `draft_policy` names the low-precision policy
    preset the draft steps run under; `k` is the fixed draft length per
    round (every round drafts exactly k and verifies k+1)."""
    draft_policy: str
    k: int = 4

    def __post_init__(self):
        if self.k < 1:
            raise ValueError("spec k must be >= 1")


def validate_policy_pair(draft_policy, serve_policy):
    """Draft and serving policies must share one cache layout.  Returns
    the draft policy object."""
    dpol, spol = get_policy(draft_policy), get_policy(serve_policy)
    if not dpol.kv_quantized:
        raise ValueError(
            f"draft policy {draft_policy!r} keeps a raw f32 cache; "
            "speculative drafting shares the serving engine's paged "
            "code pool, so pick a draft preset with fmt_kv set "
            "(e.g. w4a4_kv4_attn4 over an fp4 cache)")
    if (dpol.fmt_kv, dpol.kv_packed) != (spol.fmt_kv, spol.kv_packed):
        raise ValueError(
            f"draft policy {draft_policy!r} stores KV as "
            f"{dpol.fmt_kv}/packed={dpol.kv_packed} but the serving "
            f"policy stores {spol.fmt_kv}/packed={spol.kv_packed}; "
            "draft and verify must share the cache format (pick a "
            "draft preset with the same fmt_kv/kv_packed)")
    return dpol


def make_draft_step(draft_model, scfg: SamplerConfig):
    """One draft decode step: (params, batch, caches, rids) -> (token (B,)
    int32, draft_probs (B, V) | None, caches).

    `batch` is the engine's decode batch ({"tokens": (B, 1), "index": (B,)
    positions}); the proposed token's timeline index is index + 1, which
    keys its stream (`ROLE_DRAFT`).  Greedy configs return no probs:
    acceptance is argmax prefix-match and needs none."""
    greedy = scfg.greedy

    def step(params, batch, caches, rids):
        logits, caches = draft_model.decode_step(params, batch, caches)
        tok = S.sample_tokens(logits[:, -1], rids, batch["index"] + 1,
                              scfg, role=S.ROLE_DRAFT)
        probs = None if greedy else S.sample_probs(logits[:, -1], scfg)
        return tok, probs, caches

    return step


def make_accept_fn(scfg: SamplerConfig, k: int):
    """The accept rule: (drafts, draft_probs, target_logits, rids,
    positions) -> (emitted (B, k+1) int32, n_accepted (B,) int32).

    drafts (B, k) are the proposals for timeline indices positions+1 ..
    positions+k; target_logits (B, k+1, V) are the verify pass's logits,
    row i the serving-policy distribution for index positions+i+1.
    `emitted[:, j]` holds the j-th token the round produces; exactly
    n_accepted+1 of them are valid (accepted drafts, then one correction,
    residual or bonus token), the rest are zero.

    Greedy: accept the longest prefix where draft == argmax(target), then
    emit the target argmax at the first mismatch (or the bonus argmax
    after k accepts); no stream drawn.

    Sampled: accept each draft with probability min(1, p(d)/q(d)) under
    the request's `ROLE_ACCEPT` uniform; on rejection draw the residual
    max(p - q, 0)/Z, on full acceptance the bonus from p_k, both on
    `ROLE_RESIDUAL`, so the output distribution is exactly the target's.
    An all-NaN target row degenerates to one-hot token 0 (the sampler's
    dead-row rule), so p/q stays finite."""

    def emit(drafts, acc, extra):
        idx = torch.arange(k + 1, device=drafts.device)[None]
        drafts_p = torch.nn.functional.pad(drafts, (0, 1))
        acc = acc[:, None]
        return torch.where(idx < acc, drafts_p,
                           torch.where(idx == acc, extra,
                                       torch.zeros_like(drafts_p))
                           ).to(torch.int32)

    def prefix_len(ok):
        return torch.cumprod(ok.to(torch.int32), dim=1).sum(
            dim=1).to(torch.int32)

    if scfg.greedy:
        def accept(drafts, draft_probs, target_logits, rids, positions):
            drafts = drafts.to(torch.int32)
            t = S.greedy_tokens(target_logits)               # (B, k+1)
            acc = prefix_len(drafts == t[:, :k])
            corr = torch.gather(t, 1, acc[:, None].to(torch.int64))
            return emit(drafts, acc, corr), acc

        return accept

    def accept(drafts, draft_probs, target_logits, rids, positions):
        drafts = drafts.to(torch.int32)
        d64 = drafts.to(torch.int64)
        p = S.sample_probs(target_logits, scfg)              # (B, k+1, V)
        steps = torch.arange(k, device=drafts.device)[None]
        tok_pos = positions.to(torch.int64)[:, None] + 1 + steps
        u = S.accept_uniforms(rids.to(torch.int64)[:, None], tok_pos,
                              scfg)                          # (B, k)
        p_d = torch.gather(p[:, :k], 2, d64[..., None])[..., 0]
        q_d = torch.gather(draft_probs, 2, d64[..., None])[..., 0]
        ok = u < torch.clamp_max(p_d / torch.clamp_min(q_d, 1e-38), 1.0)
        acc = prefix_len(ok)                                 # (B,)
        # the acc-th emitted token: the residual max(p - q, 0)/Z at the
        # first rejection; after k accepts q_at == p_at, the residual
        # vanishes and the draw falls through to the bonus distribution
        at = acc.to(torch.int64)[:, None, None].expand(-1, 1, p.shape[-1])
        p_at = torch.gather(p, 1, at)[:, 0]                  # (B, V)
        q_pad = torch.cat([draft_probs, p[:, k:]], dim=1)
        q_at = torch.gather(q_pad, 1, at)[:, 0]
        resid = torch.clamp_min(p_at - q_at, 0.0)
        z = resid.sum(dim=-1, keepdim=True)
        dist = torch.where(z > 0, resid / torch.clamp_min(z, 1e-38), p_at)
        keys = S.request_key(scfg.seed, rids.to(torch.int64),
                             positions.to(torch.int64) + 1 + acc,
                             S.ROLE_RESIDUAL)
        extra = S.categorical_from_probs(dist, keys)
        return emit(drafts, acc, extra[:, None]), acc

    return accept
