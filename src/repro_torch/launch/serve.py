"""Static greedy serving (port of `repro.launch.serve.generate`).

One rigid (B, s_ctx) batch stepped in lockstep: the prompt is fed
through the decode path token by token (exercising the exact serving
cache path), then generation continues greedily.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device


@torch.no_grad()
def generate(model, params, prompt, n_gen: int, s_ctx: int, device=None):
    """prompt: (B, S0) int tokens -> (B, S0 + n_gen) int32, on `device`
    (default "cuda", which must be where the model lives)."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"model lives on {model.device}, not {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(model.device)
    B, S0 = prompt.shape
    caches = model.init_caches(B, s_ctx)
    tok = prompt[:, :1]
    toks = [tok]
    for t in range(S0 + n_gen - 1):
        logits, caches = model.decode_step(params, {"tokens": tok,
                                                    "index": t}, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        tok = prompt[:, t + 1:t + 2] if t + 1 < S0 else nxt[:, None]
        toks.append(tok)
    return torch.cat(toks, dim=1).to(torch.int32)
