"""`build_model` and `Model`: the port's dense decoder, VLM, MoE, RG-LRU
and xLSTM families, and `EncDecModel`, the encoder-decoder (port of
`repro.models.registry`).

Batch conventions, as in the reference:
  forward: {"tokens": (B, S)} or, behind a stub front end (the VLM),
           {"embeddings": (B, S, d)}; the encoder-decoder takes
           {"frames": (B, Se, d), "tokens": (B, S)} -> backbone_features
           (hidden states, aux) or train_logits (logits (B, S, V) f32,
           aux), no caches; differentiable (training) over the torch
           routes
  prefill: tokens (B, S), or a batch as above -> (logits of the last
           position, caches)
  decode:  {"tokens": (B, S), "index": int, 0-dim or (B,) int32 tensor}
           (+ the encoder-decoder's {"enc_out": (B, Se, d)}, `encode`'s)
           with the caches -> (logits (B, S, V) f32, caches); a tensor
           index is read on the device, so a captured step (a CUDA graph,
           `launch.graphs`) takes a new position at every replay
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.linear import (needs_prep, prepare_grouped_linear,
                                     prepare_linear)
from repro_torch.core.tree import tree_map

from . import layers as L
from .config import ModelConfig
from .transformer import (apply_stack, family_pattern, init_block,
                          init_block_cache, layer_kinds, n_grouped)

_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16,
           "bfloat16": torch.bfloat16, "fp16": torch.float16}

MIXERS = ("attn", "rg", "mix", "cross")  # a block's sequence mixers
MLP_LINEARS = ("wg", "wu", "wd")        # SwiGLU's (GELU: wu, wd), dense or
                                        # the MoE expert stacks


class Model:
    """A model of a patterned stack bound to a config and a device.

    Params are a dict {"layers": [block dicts], "norm_f", "embed"} and,
    untied, "unembed"; a linear is {"w": f32 master} (plus "b" under
    qkv_bias) and, for the kernel policies, the load-time serving weights
    (`prepare_params`); a MoE block's "mlp" holds the router and the (E,
    d_in, d_out) expert stacks.  Layer l is a block of kind
    `self.kinds[l]` (`transformer.family_pattern`)."""

    def __init__(self, cfg: ModelConfig, device):
        self.cfg = cfg
        self.device = device
        self.dtype = _DTYPES[cfg.dtype]
        self.pattern = family_pattern(cfg)
        self.kinds = layer_kinds(cfg)

    def init(self, generator: torch.Generator) -> dict:
        """Random params with the reference init's shapes and scales
        (normal * d_in^-0.5 linears, 0.02 embeddings, unit norms, f32),
        drawn from `generator` on the model's device, then prepared."""
        cfg, dev = self.cfg, self.device
        params = {"layers": [init_block(generator, cfg, kind, dev)
                             for kind in self.kinds],
                  "norm_f": L.init_norm(cfg.d_model, dev, cfg.norm),
                  "embed": L.init_embedding(generator, cfg.vocab_size,
                                            cfg.d_model, dev)}
        if not cfg.tie_embeddings:
            params["unembed"] = L.init_embedding(generator, cfg.vocab_size,
                                                 cfg.d_model, dev)
        return self.prepare_params(params)

    def unembed_table(self, params):
        """The (V, d) table the logits are taken against: the embedding's
        when tied, else params["unembed"]'s."""
        return params["embed" if self.cfg.tie_embeddings
                      else "unembed"]["table"]

    def stacks(self):
        """(params key, the layers' kinds, how many of them the reference
        stacks on its scan axis) of each layer list."""
        return [("layers", self.kinds, n_grouped(self.cfg))]

    def prepare_params(self, params: dict) -> dict:
        """Add the kernels' load-time weights to every linear and expert
        stack whose route consumes them (a no-op otherwise): each linear
        of a block's mixers (attention, cross-attention, RG-LRU, mLSTM /
        sLSTM; not the conv, lam or r) and MLP.  The router stays f32 (the
        reference's "fp32" policy)."""
        pol, moe = self.cfg.policy, self.cfg.is_moe
        prep_dense = needs_prep(pol)
        prep_experts = moe and needs_prep(pol, "grouped_matmul")
        for key, _, _ in self.stacks():
            for lp in params[key]:
                for mixer in MIXERS if prep_dense else ():
                    for lin in lp.get(mixer, {}).values():
                        if isinstance(lin, dict) and "w" in lin:
                            prepare_linear(lin, pol, self.dtype)
                mlp = lp.get("mlp", {})
                for name in (n for n in MLP_LINEARS if n in mlp):
                    if prep_experts:
                        prepare_grouped_linear(mlp[name], pol)
                    elif prep_dense and not moe:
                        prepare_linear(mlp[name], pol, self.dtype)
        return params

    def decay_mask(self, params) -> dict:
        """AdamW's weight-decay flags in params' structure: the reference
        decays leaves of 2 dims and more in its layout, where the leaves
        of the scan groups' layers carry the scan axis, so all of them
        decay (norm scales and `lam` too); a tail layer's leaves and the
        other params decay from 2 dims on."""
        stacks = self.stacks()
        keys = {key for key, _, _ in stacks}
        mask = {k: tree_map(lambda p: p.ndim >= 2, v)
                for k, v in params.items() if k not in keys}
        for key, _, grouped in stacks:
            mask[key] = [tree_map(lambda p, g=(i < grouped):
                                  g or p.ndim >= 2, lp)
                         for i, lp in enumerate(params[key])]
        return mask

    def init_caches(self, batch_size: int, s_ctx: int) -> list:
        return [init_block_cache(self.cfg, kind, batch_size, s_ctx,
                                 self.dtype, self.device)
                for kind in self.kinds]

    def embed_in(self, params, batch):
        """The stack's input: a stub front end's batch["embeddings"] in the
        compute dtype, else the embeddings of batch["tokens"] (or of a
        tokens tensor)."""
        if isinstance(batch, dict):
            if "embeddings" in batch:
                return batch["embeddings"].to(self.dtype)
            batch = batch["tokens"]
        return L.apply_embedding(params["embed"], batch, self.dtype)

    def _forward(self, params, batch, offset, caches, per_row=False):
        """-> (final hidden states, caches, aux); serving drops the aux
        loss, as the reference's prefill and decode_step do."""
        x = self.embed_in(params, batch)
        x, caches, aux = apply_stack(params["layers"], x, self.cfg,
                                     offset=offset, caches=caches,
                                     per_row=per_row)
        return L.apply_norm(params["norm_f"], x, eps=self.cfg.norm_eps,
                            per_row=per_row), caches, aux

    def backbone_features(self, params, batch):
        """The cacheless full-sequence forward: batch {"tokens": (B, S)}
        or {"embeddings": (B, S, d)} -> (final hidden states (B, S, d),
        aux loss); differentiable, with the config's remat while autograd
        records."""
        x, _, aux = self._forward(params, batch, 0, None)
        return x, aux

    def train_logits(self, params, batch):
        """-> (f32 logits (B, S, V), aux loss); differentiable."""
        x, aux = self.backbone_features(params, batch)
        return L.apply_unembed(x, self.unembed_table(params)), aux

    @torch.no_grad()
    def prefill(self, params, batch):
        """tokens (B, S), or a batch {"tokens"} / {"embeddings"} -> (f32
        logits of the last position, caches of S positions)."""
        lead = batch if torch.is_tensor(batch) else batch.get(
            "embeddings", batch.get("tokens"))
        caches = self.init_caches(lead.shape[0], lead.shape[1])
        x, caches, _ = self._forward(params, batch, 0, caches)
        return L.apply_unembed(x[:, -1:], self.unembed_table(params)), \
            caches

    @torch.no_grad()
    def decode_step(self, params, batch, caches):
        """One step over batch["tokens"] (B, S) at batch["index"]; the
        caches update in place and are returned.  S > 1 over the paged
        pool is the speculative verify pass, whose every query row carries
        the bits of a decode step at its position (`layers` module doc)."""
        verify = ("tokens" in batch and batch["tokens"].shape[1] > 1
                  and bool(caches) and "block_table" in caches[0])
        x, caches, _ = self._forward(params, batch, batch["index"], caches,
                                     per_row=verify)
        return L.apply_unembed(x, self.unembed_table(params),
                               per_row=verify), caches


class EncDecModel(Model):
    """The encoder-decoder (whisper-style; the reference's
    `_build_encdec`): an encoder stack of n_enc_layers "enc" blocks over
    a stub front end's frames, its final norm, and a decoder stack of
    n_layers "dec" blocks over token embeddings plus the learned
    positions `pos_dec` (max_seq, d), cross-attending to the encoder's
    output.  Params {"enc_layers", "dec_layers": [block dicts],
    "enc_norm", "norm_f", "embed", "pos_dec"} and, untied, "unembed".
    Caches are the decoder's self-attention caches; decode steps take
    the encoder's output in the batch and project the cross keys and
    values from it at every step, as the reference does."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__(cfg, device)
        self.enc_kinds = ["enc"] * (cfg.n_enc_layers or cfg.n_layers)

    def stacks(self):
        # each stack is one uniform pattern: the reference scans all of it
        return [("enc_layers", self.enc_kinds, len(self.enc_kinds)),
                ("dec_layers", self.kinds, len(self.kinds))]

    def init(self, generator: torch.Generator) -> dict:
        cfg, dev = self.cfg, self.device
        d = cfg.d_model
        params = {key: [init_block(generator, cfg, kind, dev)
                        for kind in kinds]
                  for key, kinds, _ in self.stacks()}
        params.update(
            enc_norm=L.init_norm(d, dev, cfg.norm),
            norm_f=L.init_norm(d, dev, cfg.norm),
            embed=L.init_embedding(generator, cfg.vocab_size, d, dev),
            pos_dec=torch.randn((cfg.max_seq, d), generator=generator,
                                dtype=torch.float32, device=dev) * 0.01)
        if not cfg.tie_embeddings:
            params["unembed"] = L.init_embedding(generator, cfg.vocab_size,
                                                 d, dev)
        return self.prepare_params(params)

    def encode(self, params, frames):
        """frames (B, Se, d) -> the encoder's output (B, Se, d) in the
        compute dtype."""
        cfg = self.cfg
        x, _, _ = apply_stack(params["enc_layers"], frames.to(self.dtype),
                              cfg, kinds=self.enc_kinds)
        return L.apply_norm(params["enc_norm"], x, eps=cfg.norm_eps)

    def _dec_embed(self, params, tokens, index):
        """Token embeddings plus the learned positions: rows [0, S) for S
        > 1; for S == 1 the row at `index` (an int or a 0-dim tensor) as
        `dynamic_slice_in_dim` takes it: a negative index counts from the
        end, then the start is clamped to [0, max_seq - 1]."""
        x = L.apply_embedding(params["embed"], tokens, self.dtype)
        pos, S = params["pos_dec"], tokens.shape[1]
        n = pos.shape[0]
        if S > 1:
            p = pos[:S]
        elif torch.is_tensor(index):
            at = index.to(device=pos.device, dtype=torch.int64)
            at = torch.clamp(torch.where(at < 0, at + n, at), 0, n - 1)
            p = pos.index_select(0, at.reshape(1))
        else:
            at = int(index)
            at = min(max(at + n if at < 0 else at, 0), n - 1)
            p = pos[at:at + 1]
        return x + p.to(self.dtype)[None]

    def _decoder(self, params, x, enc_out, offset, caches):
        x, caches, aux = apply_stack(params["dec_layers"], x, self.cfg,
                                     offset=offset, caches=caches,
                                     enc_out=enc_out, kinds=self.kinds)
        return L.apply_norm(params["norm_f"], x, eps=self.cfg.norm_eps), \
            caches, aux

    def backbone_features(self, params, batch):
        """batch {"frames", "tokens"} -> (the decoder's final hidden
        states, aux); differentiable."""
        enc_out = self.encode(params, batch["frames"])
        x = self._dec_embed(params, batch["tokens"], 0)
        x, _, aux = self._decoder(params, x, enc_out, 0, None)
        return x, aux

    @torch.no_grad()
    def prefill(self, params, batch):
        """batch {"frames", "tokens": (B, S)} -> (f32 logits of the last
        position, the decoder's caches of S positions)."""
        enc_out = self.encode(params, batch["frames"])
        tokens = batch["tokens"]
        x = self._dec_embed(params, tokens, 0)
        caches = self.init_caches(tokens.shape[0], tokens.shape[1])
        x, caches, _ = self._decoder(params, x, enc_out, 0, caches)
        return L.apply_unembed(x[:, -1:], self.unembed_table(params)), \
            caches

    @torch.no_grad()
    def decode_step(self, params, batch, caches):
        """One step over batch["tokens"] at batch["index"], cross-attending
        to batch["enc_out"]; the caches update in place."""
        index = batch["index"]
        x = self._dec_embed(params, batch["tokens"], index)
        x, caches, _ = self._decoder(params, x,
                                     batch["enc_out"].to(self.dtype), index,
                                     caches)
        return L.apply_unembed(x, self.unembed_table(params)), caches


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device` (default "cuda"; raises without a card
    unless the caller passes device="cpu")."""
    cls = EncDecModel if cfg.family == "encdec" else Model
    return cls(cfg, resolve_device(device))
