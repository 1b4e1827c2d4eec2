"""`build_model` and `Model`: the port's dense decoder and MoE families
(port of the decoder path of `repro.models.registry`).

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
from .transformer import apply_stack, init_block, init_block_cache

_DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16,
           "bfloat16": torch.bfloat16, "fp16": torch.float16}

ATTN_LINEARS = ("wq", "wk", "wv", "wo")
MLP_LINEARS = ("wg", "wu", "wd")        # dense MLP, or the MoE expert stacks


class Model:
    """A dense or MoE decoder bound to a config and a device.

    Params are a dict {"layers": [block dicts], "norm_f", "embed"}; a
    linear is {"w": f32 master} plus, for the kernel policies, the
    load-time serving weights (`prepare_params`); a MoE block's "mlp"
    holds the router and the (E, d_in, d_out) expert stacks."""

    def __init__(self, cfg: ModelConfig, device):
        if cfg.family not in ("decoder", "moe"):
            raise NotImplementedError(
                f"{cfg.family} models join the port in a later slice "
                "(ROADMAP Queue 1, \"Other families\")")
        if not cfg.tie_embeddings:
            raise NotImplementedError("the port serves tied-embedding "
                                      "decoders (qwen3, llama3.2, "
                                      "granite-moe)")
        self.cfg = cfg
        self.device = device
        self.dtype = _DTYPES[cfg.dtype]

    def init(self, generator: torch.Generator) -> dict:
        """Random params with the reference init's shapes and scales
        (normal * d_in^-0.5 linears, 0.02 embedding, unit norms, f32),
        drawn from `generator` on the model's device, then prepared."""
        cfg, dev = self.cfg, self.device
        params = {"layers": [init_block(generator, cfg, dev)
                             for _ in range(cfg.n_layers)],
                  "norm_f": L.init_norm(cfg.d_model, dev),
                  "embed": L.init_embedding(generator, cfg.vocab_size,
                                            cfg.d_model, dev)}
        return self.prepare_params(params)

    def prepare_params(self, params: dict) -> dict:
        """Add the kernels' load-time weights to every linear and expert
        stack whose route consumes them (a no-op otherwise).  The router
        stays f32 (the reference's "fp32" policy)."""
        pol, moe = self.cfg.policy, self.cfg.is_moe
        prep_dense = needs_prep(pol)
        prep_experts = moe and needs_prep(pol, "grouped_matmul")
        for lp in params["layers"]:
            for name in ATTN_LINEARS if prep_dense else ():
                prepare_linear(lp["attn"][name], pol, self.dtype)
            for name in MLP_LINEARS:
                if prep_experts:
                    prepare_grouped_linear(lp["mlp"][name], pol)
                elif prep_dense and not moe:
                    prepare_linear(lp["mlp"][name], pol, self.dtype)
        return params

    def decay_mask(self, params) -> dict:
        """AdamW's weight-decay flags in params' structure: the reference
        decays leaves of 2 dims and more in its layout, where every
        layer's leaves carry the scan axis, so each layer's norm scales
        decay too; the final norm does not."""
        return {k: tree_map(lambda p, stacked=(k == "layers"):
                            stacked or p.ndim >= 2, v)
                for k, v in params.items()}

    def init_caches(self, batch_size: int, s_ctx: int) -> list:
        return [init_block_cache(self.cfg, batch_size, s_ctx, self.dtype,
                                 self.device)
                for _ in range(self.cfg.n_layers)]

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
        return L.apply_unembed(x, params["embed"]["table"]), aux

    @torch.no_grad()
    def prefill(self, params, tokens):
        """tokens (B, S) -> (f32 logits of the last position, caches)."""
        caches = self.init_caches(tokens.shape[0], tokens.shape[1])
        x, caches, _ = self._forward(params, tokens, 0, caches)
        return L.apply_unembed(x[:, -1:], params["embed"]["table"]), caches

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
        return L.apply_unembed(x, params["embed"]["table"],
                               per_row=verify), caches


def build_model(cfg: ModelConfig, device=None) -> Model:
    """The model on `device` (default "cuda"; raises without a card
    unless the caller passes device="cpu")."""
    return Model(cfg, resolve_device(device))
