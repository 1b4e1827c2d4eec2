"""The flash kernels of two checkouts, side by side on one card.

    python3 tools/flash_ab.py OTHER [--this DIR]

OTHER and DIR (default: this checkout) are repository roots, for
example the parent commit unpacked with `git archive`.  Each side runs
in its own process (both packages are `repro_torch`), in turns OTHER,
THIS, THIS, OTHER; each builds its own kernels, writes the f32 flash
kernel's outputs on seeded inputs (one layer of qwen3-4b's prefill, S
4096, in f32 and bf16; hd 64; S 1000 with blocks of 125) and times, as
CUDA-graph replays of 10 calls, the f32 kernel at S 4096 in f32 and the
DPA kernel at one layer of qwen3-4b scoring (raw fp4 K/V, bf16).  Then
it says whether the two sides' f32 outputs are the same bits and prints
the card's name and power limit and one JSON line.  Needs a CUDA card
and nvcc; the outputs go to `build/flash_ab/`.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "flash_ab"
CALLS = 10
F32_CASES = ((32, 8, 4096, 128, "float32"), (32, 8, 4096, 128, "bfloat16"),
             (16, 8, 1024, 64, "float32"), (32, 8, 1000, 128, "float32"))


def graph_ms(fn) -> float:
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(CALLS):
            fn()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / CALLS


def worker(tree: Path, tag: str) -> None:
    """One side: outputs to OUT/<tag>_*.pt, times as a JSON line."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    build.load_library()
    gen = torch.Generator(device="cuda").manual_seed(7)

    def qkv(H, KV, S, hd, dtype):
        return [torch.randn((1, h, S, hd), generator=gen, device="cuda").to(
            dtype) for h in (H, KV, KV)]

    res = {}
    for H, KV, S, hd, dt in F32_CASES:
        q, k, v = qkv(H, KV, S, hd, getattr(torch, dt))
        b = 125 if S == 1000 else 128
        out = FA.flash_attention(q, k, v, bq=b, bk=b)
        torch.save(out.cpu(), OUT / f"{tag}_f32_{H}_{S}_{hd}_{dt}.pt")
        if (S, dt) == (4096, "float32"):
            res["f32_flash_ms"] = graph_ms(lambda: FA.flash_attention(q, k, v))
    q, k, v = qkv(32, 8, 4096, 128, torch.bfloat16)
    res["dpa_flash_ms"] = graph_ms(lambda: FA.dpa_flash_attention(
        q, k, v, fmt="fp8_e4m3", fmt_kv="fp4_e2m1"))
    print(json.dumps(res), flush=True)


def main() -> None:
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]).resolve(), sys.argv[3])
        return
    args = sys.argv[1:]
    if not args or args[0].startswith("-"):
        sys.exit(__doc__)
    other = Path(args[0]).resolve()
    this = Path(args[args.index("--this") + 1]).resolve() \
        if "--this" in args else ROOT
    OUT.mkdir(parents=True, exist_ok=True)
    runs = {"other": [], "this": []}
    for tag, tree in (("other", other), ("this", this), ("this", this),
                      ("other", other)):
        out = subprocess.run([sys.executable, __file__, "--worker", str(tree),
                              tag], capture_output=True, text=True)
        if out.returncode != 0:
            sys.exit(f"flash_ab: {tag} ({tree}) failed:\n{out.stderr[-3000:]}")
        runs[tag].append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"{tag}: {runs[tag][-1]}", flush=True)
    import torch
    same = {}
    for H, KV, S, hd, dt in F32_CASES:
        name = f"f32_{H}_{S}_{hd}_{dt}"
        same[name] = torch.equal(torch.load(OUT / f"other_{name}.pt"),
                                 torch.load(OUT / f"this_{name}.pt"))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"f32 flash outputs, same bits on both sides: {same}")
    print(card)
    print(json.dumps({"card": card, "other": str(other), "this": str(this),
                      "ms": runs, "f32_same_bits": same}))


if __name__ == "__main__":
    main()
