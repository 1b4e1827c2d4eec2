"""Static greedy serving (port of `repro.launch.serve.generate`).

One rigid (B, s_ctx) batch stepped in lockstep: the prompt is fed
through the decode path token by token (exercising the exact serving
cache path), then generation continues greedily.  Each step is
`distributed.step.make_serve_step`, which the reference jits; on the
card it is captured once per call as a CUDA graph (`launch.graphs`).
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.distributed.step import make_serve_step
from repro_torch.launch.graphs import Step, StepGraph


@torch.no_grad()
def generate(model, params, prompt, n_gen: int, s_ctx: int, device=None,
             graphs: bool = True):
    """prompt: (B, S0) int tokens -> (B, S0 + n_gen) int32, on `device`
    (default "cuda", which must be where the model lives).

    On the card with `graphs` the serve step is one CUDA graph over two
    buffers, the (B, 1) tokens and the 0-dim int32 index, filled device
    to device at each step (the next prompt column or the replayed next
    tokens; the indices are one device `arange`), so nothing waits for
    the host before the final concatenation.  Its capture's warm-up call
    is step 0 itself (the buffers start at step 0's inputs), so the
    call makes as many model steps as the eager one.  With
    `graphs=False`, and always on the CPU, the same step runs eagerly.
    `generate.capture_stats` holds the last call's capture statistics
    (`StepGraph.stats`; None when eager)."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"model lives on {model.device}, not {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(model.device)
    B, S0 = prompt.shape
    caches = model.init_caches(B, s_ctx)
    serve_step = make_serve_step(model)

    def step(tokens, index):
        nxt, _ = serve_step(params, {"tokens": tokens, "index": index},
                            caches)
        return nxt

    buffers = {"tokens": prompt[:, :1].clone(),
               "index": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}
    run = (StepGraph(step, buffers, name="serve step")
           if graphs and model.device.type == "cuda"
           else Step(step, buffers, name="serve step"))
    generate.capture_stats = getattr(run, "stats", None)
    index = torch.arange(S0 + n_gen - 1, dtype=torch.int32,
                         device=model.device)
    toks = [prompt[:, :1]]
    for t in range(S0 + n_gen - 1):
        nxt = run(index=index[t]) if t else run.first()
        tok = (prompt[:, t + 1:t + 2] if t + 1 < S0
               else nxt[:, None].to(torch.int64))
        run.load(tokens=tok)
        toks.append(tok)
    return torch.cat(toks, dim=1).to(torch.int32)


generate.capture_stats = None
