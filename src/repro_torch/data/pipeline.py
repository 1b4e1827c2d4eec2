"""Deterministic, seekable, sharded data pipeline (port of
`repro.data.pipeline`).

Fault-tolerance contract: batch(step) is a pure function of (seed, step,
shard), so a restart from a checkpoint resumes the exact token stream
with no iterator state to persist.  Two sources:

  SyntheticLM  — Zipf unigrams with a learnable bigram (with p = 0.5 the
                 next token is perm[cur]), drawn from the reference's own
                 threefry streams (`serving.threefry`): keys and coins
                 equal JAX's bit for bit, and a token equals JAX's
                 wherever its Gumbel winner leads by more than the last
                 bit of a `log` (the sampler's contract).
  MemmapTokens — packed uint16/uint32 token files, sliced per (step,
                 shard) without loading the file; numpy on both sides,
                 so its batches equal the reference's bit for bit.

Both emit {"tokens": (B, S), "labels": (B, S)} int64 tensors on the
pipeline's device, labels the next tokens.  With a stub front end
(`frontend="stub"`) a batch also carries what the stubbed encoder would
hand the model, drawn as `jax.random.normal` draws it (`threefry.normal`:
the uniforms bit for bit, the normals to a few ulp): the audio family's
{"frames": (B, frames, d_model)} f32 beside the tokens, or, without
frames, the VLM's {"embeddings": (B, S, d_model)} f32 in place of the
tokens.  SyntheticLM draws them from its step's key, MemmapTokens from
`PRNGKey(step)`, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.serving import threefry as TF


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int              # global batch
    seq: int
    seed: int = 0
    kind: str = "synthetic"          # synthetic | memmap
    path: Optional[str] = None       # memmap token file
    n_shards: int = 1
    shard: int = 0
    frontend: str = "none"           # none | stub (emit embeddings)
    d_model: int = 0                 # for stub frontends
    frames: int = 0                  # encdec: encoder length


def _add_frontend(batch: dict, cfg: DataConfig, key) -> dict:
    if cfg.frontend == "stub" and cfg.frames:      # enc-dec: audio frames
        b = batch["tokens"].shape[0]
        batch["frames"] = TF.normal(key, (b, cfg.frames, cfg.d_model))
    elif cfg.frontend == "stub":                   # vlm: fused embeddings
        b, s = batch["tokens"].shape
        batch["embeddings"] = TF.normal(key, (b, s, cfg.d_model))
        del batch["tokens"]
    return batch


class SyntheticLM:
    """Zipf-distributed tokens with a deterministic bigram structure: the
    model can learn P(next | cur), so training loss decreases visibly."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        v = cfg.vocab_size
        rng = np.random.default_rng(cfg.seed)
        self._perm = torch.from_numpy(rng.permutation(v)).to(
            device=self.device, dtype=torch.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._logits = torch.from_numpy(
            np.log(p / p.sum()).astype(np.float32)).to(self.device)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b_local = cfg.batch // cfg.n_shards
        key = TF.fold_in(TF.fold_in(TF.prng_key(cfg.seed, self.device),
                                    step), cfg.shard)
        k1, k2 = TF.split(key)
        base = TF.categorical(k1, self._logits,
                              shape=(b_local, cfg.seq + 1))
        # bigram mixing: with p=0.5 the next token is perm[cur] (learnable)
        follow = self._perm[base[:, :-1]]
        coin = TF.bernoulli(k2, 0.5, tuple(follow.shape))
        seq = torch.cat([base[:, :1], torch.where(coin, follow, base[:, 1:])],
                        dim=1)
        return _add_frontend({"tokens": seq[:, :-1], "labels": seq[:, 1:]},
                             cfg, key)


class MemmapTokens:
    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = np.uint32 if cfg.vocab_size > 65535 else np.uint16
        self._data = np.memmap(cfg.path, dtype=dtype, mode="r")
        self._n = len(self._data)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        b_local = cfg.batch // cfg.n_shards
        span = cfg.seq + 1
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 97 + cfg.shard)
        starts = rng.integers(0, self._n - span, size=b_local)
        rows = np.stack([self._data[s:s + span] for s in starts]).astype(
            np.int64)
        rows = torch.from_numpy(rows).to(self.device)
        return _add_frontend({"tokens": rows[:, :-1], "labels": rows[:, 1:]},
                             cfg, TF.prng_key(step, self.device))


def make_pipeline(cfg: DataConfig, device=None):
    """The config's source on `device` (default "cuda"; the CPU when the
    caller asks for it)."""
    return (MemmapTokens(cfg, device) if cfg.kind == "memmap"
            else SyntheticLM(cfg, device))
