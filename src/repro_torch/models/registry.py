"""`build_model` and `Model`: the port's dense decoder, MoE, RG-LRU and
xLSTM families (port of `repro.models.registry`; the encoder-decoder and
VLM families are not ported yet).

Batch conventions, as in the reference:
  forward: {"tokens": (B, S)} -> backbone_features (hidden states, aux)
           or train_logits (logits (B, S, V) f32, aux), no caches;
           differentiable (training) over the torch routes
  prefill: tokens (B, S) -> (logits of the last position, caches)
  decode:  {"tokens": (B, S), "index": int, 0-dim or (B,) int32 tensor}
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

MIXERS = ("attn", "rg", "mix")          # a block's sequence mixer
MLP_LINEARS = ("wg", "wu", "wd")        # dense MLP, or the MoE expert stacks
OTHER_FAMILIES_ITEM = "ROADMAP Queue 1, \"Other families\""


class Model:
    """A model of a patterned stack bound to a config and a device.

    Params are a dict {"layers": [block dicts], "norm_f", "embed"} and,
    untied, "unembed"; a linear is {"w": f32 master} (plus "b" under
    qkv_bias) and, for the kernel policies, the load-time serving weights
    (`prepare_params`); a MoE block's "mlp" holds the router and the (E,
    d_in, d_out) expert stacks.  Layer l is a block of kind
    `self.kinds[l]` (`transformer.family_pattern`)."""

    def __init__(self, cfg: ModelConfig, device):
        if cfg.family in ("encdec", "vlm") or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.family} models ({cfg.name}) join the port in a later "
                f"slice ({OTHER_FAMILIES_ITEM})")
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
                  "norm_f": L.init_norm(cfg.d_model, dev),
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

    def prepare_params(self, params: dict) -> dict:
        """Add the kernels' load-time weights to every linear and expert
        stack whose route consumes them (a no-op otherwise): each linear
        of a block's mixer (attention, RG-LRU, mLSTM / sLSTM; not the
        conv, lam or r) and MLP.  The router stays f32 (the reference's
        "fp32" policy)."""
        pol, moe = self.cfg.policy, self.cfg.is_moe
        prep_dense = needs_prep(pol)
        prep_experts = moe and needs_prep(pol, "grouped_matmul")
        for lp in params["layers"]:
            for mixer in MIXERS if prep_dense else ():
                for lin in lp.get(mixer, {}).values():
                    if isinstance(lin, dict) and "w" in lin:
                        prepare_linear(lin, pol, self.dtype)
            for name in MLP_LINEARS if "mlp" in lp else ():
                if prep_experts:
                    prepare_grouped_linear(lp["mlp"][name], pol)
                elif prep_dense and not moe:
                    prepare_linear(lp["mlp"][name], pol, self.dtype)
        return params

    def decay_mask(self, params) -> dict:
        """AdamW's weight-decay flags in params' structure: the reference
        decays leaves of 2 dims and more in its layout, where the leaves
        of the scan groups' layers carry the scan axis, so all of them
        decay (norm scales and `lam` too); a tail layer's leaves and the
        other params decay from 2 dims on."""
        grouped = n_grouped(self.cfg)
        mask = {k: tree_map(lambda p: p.ndim >= 2, v)
                for k, v in params.items() if k != "layers"}
        mask["layers"] = [tree_map(lambda p, g=(i < grouped):
                                   g or p.ndim >= 2, lp)
                          for i, lp in enumerate(params["layers"])]
        return mask

    def init_caches(self, batch_size: int, s_ctx: int) -> list:
        return [init_block_cache(self.cfg, kind, batch_size, s_ctx,
                                 self.dtype, self.device)
                for kind in self.kinds]

    def _forward(self, params, tokens, offset, caches, per_row=False):
        """-> (final hidden states, caches, aux); serving drops the aux
        loss, as the reference's prefill and decode_step do."""
        x = L.apply_embedding(params["embed"], tokens, self.dtype)
        x, caches, aux = apply_stack(params["layers"], x, self.cfg,
                                     offset=offset, caches=caches,
                                     per_row=per_row)
        return L.apply_norm(params["norm_f"], x, eps=self.cfg.norm_eps,
                            per_row=per_row), caches, aux

    def backbone_features(self, params, batch):
        """The cacheless full-sequence forward: batch {"tokens": (B, S)}
        -> (final hidden states (B, S, d), aux loss); differentiable, with
        the config's remat while autograd records."""
        x, _, aux = self._forward(params, batch["tokens"], 0, None)
        return x, aux

    def train_logits(self, params, batch):
        """-> (f32 logits (B, S, V), aux loss); differentiable."""
        x, aux = self.backbone_features(params, batch)
        return L.apply_unembed(x, self.unembed_table(params)), aux

    @torch.no_grad()
    def prefill(self, params, tokens):
        """tokens (B, S) -> (f32 logits of the last position, caches)."""
        caches = self.init_caches(tokens.shape[0], tokens.shape[1])
        x, caches, _ = self._forward(params, tokens, 0, caches)
        return L.apply_unembed(x[:, -1:], self.unembed_table(params)), \
            caches

    @torch.no_grad()
    def decode_step(self, params, batch, caches):
        """One step over batch["tokens"] (B, S) at batch["index"]; the
        caches update in place and are returned.  S > 1 over the paged
        pool is the speculative verify pass, whose every query row carries
        the bits of a decode step at its position (`layers` module doc)."""
        verify = (batch["tokens"].shape[1] > 1 and bool(caches)
                  and "block_table" in caches[0])
        x, caches, _ = self._forward(params, batch["tokens"],
                                     batch["index"], caches, per_row=verify)
        return L.apply_unembed(x, self.unembed_table(params),
                               per_row=verify), caches


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device` (default "cuda"; raises without a card
    unless the caller passes device="cpu")."""
    return Model(cfg, resolve_device(device))
