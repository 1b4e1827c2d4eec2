"""The cost of the train step's deterministic indexing forms on the card.

    python3 tools/train_op_costs.py

Forward + backward of the embedding gather and of the MoE dispatch and
combine gathers at granite-moe-1b-a400m's training shapes (batch 2 x seq
4096, d_model 1024, 32 experts top-8, capacity 1.25), each of the port's
forms (`models/layers.py`: `F.embedding`, the dispatch's repeat-then-
permute gather, the combine's `buf[rows, e, pos]`) beside the plain
indexing it replaces.  Each is timed (CUDA events, median of 10) and run
3 times with its gradient compared bit for bit across the runs; indices
repeat (the `SyntheticLM` batch's Zipf tokens; random slots for the
combine), so an atomic accumulate shows.  Needs a CUDA card; prints the
card's name and power limit, one line per form and one JSON line.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, S = 2, 4096


def median_ms(fn, n=10):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[n // 2]


def forms(cfg):
    """{name: (the leaf the gradient is taken of, the forward)}."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    d, E, K = cfg.d_model, cfg.n_experts, cfg.top_k
    C = int(cfg.capacity_factor * S * K / E) + 1
    gen = torch.Generator(device="cuda").manual_seed(3)
    ids = make_pipeline(DataConfig(vocab_size=cfg.vocab_size, batch=B,
                                   seq=S, seed=0),
                        device="cuda").batch(0)["tokens"]
    table = torch.randn((cfg.vocab_size, d), generator=gen, device="cuda",
                        requires_grad=True)
    x = torch.randn((B, S, d), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    order = torch.argsort(torch.rand((B, S * K), generator=gen,
                                     device="cuda"), dim=-1)
    buf = torch.randn((B, E, C, d), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    rows = torch.arange(B, device="cuda")[:, None].expand(B, S * K)
    flat_e = torch.randint(0, E, (B, S * K), generator=gen, device="cuda")
    pos = torch.randint(0, C, (B, S * K), generator=gen, device="cuda")
    return gen, {
        "embedding: table[ids]": (table, lambda: table[ids]),
        "embedding: F.embedding (the port's)": (
            table, lambda: torch.nn.functional.embedding(ids, table)),
        "dispatch: x.gather(order // K)": (x, lambda: x.gather(
            1, (order // K)[..., None].expand(B, S * K, d))),
        "dispatch: repeat K, gather(order) (the port's)": (
            x, lambda: x[:, :, None].expand(B, S, K, d).reshape(
                B, S * K, d).gather(1, order[..., None].expand(
                    B, S * K, d))),
        "combine: buf[rows, e, pos] (the port's)": (
            buf, lambda: buf[rows, flat_e, pos]),
        "combine: gather(e C + pos)": (buf, lambda: buf.reshape(
            B, E * C, d).gather(1, (flat_e * C + pos)[..., None].expand(
                B, S * K, d))),
    }


def main():
    import torch
    from repro_torch.configs import get_config
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    gen, table = forms(get_config("granite-moe-1b-a400m"))
    out = {}
    for name, (leaf, fwd) in table.items():
        g_out = torch.randn(fwd().shape, generator=gen, device="cuda",
                            dtype=leaf.dtype)

        def run(leaf=leaf, fwd=fwd, g_out=g_out):
            return torch.autograd.grad(fwd(), leaf, g_out)[0]
        grads = [run() for _ in range(3)]
        same = all(torch.equal(grads[0], g) for g in grads[1:])
        ms = median_ms(run)
        out[name] = {"ms": ms, "repeatable": same}
        print(f"{name}: forward + backward {ms:.3f} ms, gradient "
              f"{'repeatable' if same else 'NOT repeatable'} over 3 runs")
    print(json.dumps({"card": card, "forms": out}))


if __name__ == "__main__":
    main()
