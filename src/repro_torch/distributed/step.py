"""Step builders: the loss, the prefill step and the serve step (port of
the forward parts of `repro.distributed.step`).

Forward only: the gradients, the optimizer and the train steps are
ROADMAP Queue 1, "Training".  The cross-entropy is evaluated in sequence
chunks when the config's `logits_chunk` divides the sequence, so the
(B, S, V) logits of a 150k vocabulary never exist at once.  A mean is a
sum times f32(1/n), as the jitted reference computes it.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import recip
from repro_torch.models import layers as L
from repro_torch.serving.sampler import greedy_tokens


def _logsumexp(logits):
    """log(sum(exp(x - max))) + max over the last dim."""
    m = logits.amax(dim=-1, keepdim=True)
    return (torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))
            + m)[..., 0]


def _xent_terms(logits, labels):
    """-> (logz, gold) per position."""
    logz = _logsumexp(logits)
    gold = logits.gather(-1, labels[..., None].to(torch.int64))[..., 0]
    return logz, gold


def softmax_xent(logits, labels, z_coef: float = 1e-4):
    """logits (B, S, V) f32, labels (B, S) int -> scalar mean loss
    (+ z-loss)."""
    logz, gold = _xent_terms(logits, labels)
    inv_n = recip(logz.numel())
    loss = (logz - gold).sum() * inv_n
    if z_coef:
        loss = loss + z_coef * ((logz * logz).sum() * inv_n)
    return loss


def chunked_xent(params, model, x, labels, chunk: int,
                 z_coef: float = 1e-4):
    """Per-chunk unembed + cross-entropy over x (B, S, d): never holds
    more than (B, chunk, V) logits."""
    B, S, _ = x.shape
    table = params["embed"]["table"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(S // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        logz, gold = _xent_terms(L.apply_unembed(x[:, sl], table),
                                 labels[:, sl])
        total = total + ((logz - gold).sum() + z_coef * (logz * logz).sum())
    return total * recip(B * S)


def make_loss_fn(model):
    """-> loss_fn(params, {"tokens", "labels"}) -> (loss + aux, {"loss",
    "aux"}), forward only."""
    cfg = model.cfg

    @torch.no_grad()
    def loss_fn(params, batch):
        seq = batch["labels"].shape[1]
        chunk = min(cfg.logits_chunk, seq) if cfg.logits_chunk else 0
        if chunk and seq % chunk == 0:
            x, aux = model.backbone_features(params, batch)
            loss = chunked_xent(params, model, x, batch["labels"], chunk)
        else:
            logits, aux = model.train_logits(params, batch)
            loss = softmax_xent(logits, batch["labels"])
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def make_prefill_step(model):
    """-> prefill_step(params, tokens (B, S)) -> (f32 logits of the last
    position, caches): `Model.prefill`."""
    def prefill_step(params, tokens):
        return model.prefill(params, tokens)
    return prefill_step


def make_serve_step(model):
    """-> serve_step(params, batch, caches) -> (next tokens (B,) int32,
    caches): one `Model.decode_step` and the greedy choice at its last
    position, the step `generate` runs (captured as one CUDA graph on
    the card, as the reference jits it)."""
    def serve_step(params, batch, caches):
        logits, caches = model.decode_step(params, batch, caches)
        return greedy_tokens(logits[:, -1]), caches
    return serve_step
