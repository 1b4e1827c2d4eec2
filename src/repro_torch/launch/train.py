"""Training entry point (port of `repro.launch.train`): the state, the
deterministic pipeline and the supervised step loop (checkpoints every
`--ckpt-every` steps, restore and replay after a failure).

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 8 --batch 2 --seq 4096

  python -m repro_torch.launch.train --arch llama3.2-3b --reduced \
      --steps 20 --batch 8 --seq 128 --device cpu

Weights are `model.init(torch.Generator(device).manual_seed(0))` (the
reference's `PRNGKey(0)`), data `SyntheticLM` at seed 0.  Everything runs
on `--device` (default "cuda").  It prints the reference's
`step ... loss ... gnorm ... lr ...` lines every `--log-every` steps and
its `done: ... tok/s` line.

The train step runs the torch routes (STE fake-quant linears on cuBLAS,
plain attention): the CUDA kernels have no backward, so a policy whose
linears or attention resolve to a kernel route is refused
(`distributed.step.check_trainable`).  `--n-model` above 1 exits naming
ROADMAP Queue 1, "Model-parallel serving and training (`--n-model`)";
the data-parallel step with a compressed gradient wire is
`distributed.step.make_compressed_train_step`.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.distributed.step import (MODEL_PARALLEL_ITEM,
                                         make_train_step)
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.runtime.fault import Supervisor, SupervisorConfig


def build_state(model, seed: int = 0) -> dict:
    """{"params": model.init at `seed`, "opt": adamw.init} on the model's
    device."""
    gen = torch.Generator(device=model.device).manual_seed(seed)
    params = model.init(gen)
    return {"params": params, "opt": adamw.init(params)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--n-model", type=int, default=1,
                    help="model-parallel width (1: one device)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"')
    args = ap.parse_args(argv)
    if args.n_model > 1:
        ap.exit(2, f"--n-model {args.n_model}: model-parallel training is "
                   f"not ported yet ({MODEL_PARALLEL_ITEM})\n")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    over = {"max_seq": max(cfg.max_seq, args.seq)}
    if args.policy:
        over["policy"] = args.policy
    if args.vocab:
        over["vocab_size"] = args.vocab
    cfg = cfg.replace(**over)

    model = build_model(cfg, device=args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=args.steps // 10 + 1,
                                total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg)
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=args.batch, seq=args.seq,
                                    frontend=cfg.frontend,
                                    d_model=cfg.d_model,
                                    frames=16 if cfg.family == "encdec"
                                    else 0),
                         device=model.device)
    state = build_state(model, 0)
    sup = Supervisor(SupervisorConfig(ckpt_dir=args.ckpt_dir,
                                      ckpt_every=args.ckpt_every),
                     state=state)
    t_hist = []

    def on_metrics(step, m, dt):
        t_hist.append(dt)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {float(m['loss']):.4f} "
                  f"gnorm {float(m['grad_norm']):.3f} "
                  f"lr {float(m['lr']):.2e} {dt*1e3:.0f}ms")

    t0 = time.monotonic()
    state = sup.run(step_fn, pipe.batch, args.steps, on_metrics=on_metrics)
    wall = time.monotonic() - t0
    tok_s = args.steps * args.batch * args.seq / wall
    print(f"done: {args.steps} steps in {wall:.1f}s "
          f"({tok_s:.0f} tok/s, median step "
          f"{sorted(t_hist)[len(t_hist)//2]*1e3:.0f}ms)")
    return state


if __name__ == "__main__":
    main()
