"""The attention kernels of two checkouts, side by side on one card.

    python3 tools/flash_ab.py OTHER [--this DIR]

OTHER and DIR (default: this checkout) are repository roots, for
example the parent commit unpacked with `git archive`.  Each side runs
in its own process (both packages are `repro_torch`), in turns OTHER,
THIS, THIS, OTHER; each builds its own kernels, writes the outputs of
the f32 flash kernel (one layer of qwen3-4b's prefill, S 4096, in f32
and bf16; hd 64; S 1000 with blocks of 125) and of the paged decode
kernel (one decode layer at each engine's shape: qwen3-4b hd 128 and
granite-moe-1b hd 64, B 4, lengths 256/201/101/18, packed-fp4 KV) on
seeded inputs, and times, as CUDA-graph replays of 10 calls, the f32
flash kernel at S 4096 in f32 and in bf16 (path C's instance), the DPA
kernel at one layer of qwen3-4b scoring (raw fp4 K/V, bf16), paged
decode at both shapes, and the row quantizers (E4M3 and packed E2M1
codes of bf16 rows) at qwen3-4b's MLP activations (4096 x 9728) and at
path D's K/V pre-pass rows (32,768 x 128).  Then it reports the largest
difference between the two sides' outputs against the card checks' pins
(`FLASH_F32_RTOL` relative to the largest output in f32, one bf16 ulp
over it in bf16; `PAGED_DECODE_CARD_TOL` absolute; the quantizers' codes
and scales the same bytes) and prints the card's name and power limit
and one JSON line.  Needs a CUDA card and nvcc; the outputs go to
`build/flash_ab/`.
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
# paged decode at the engines' shapes: (name, H, KV, hd)
PAGED_CASES = (("qwen3-4b", 32, 8, 128), ("granite-moe-1b", 16, 8, 64))
PAGED_LENGTHS = (256, 201, 101, 18)
# the row quantizers' timed shapes (bf16 rows) and instances
QUANT_SHAPES = ((4096, 9728), (32768, 128))
QUANT_FMTS = ("fp8_e4m3", "packed")
FLASH_F32_RTOL = 2e-6             # chip_smoke.py's pins
PAGED_DECODE_CARD_TOL = 2e-2


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
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import quantize as QZ
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
        if S == 4096:
            name = "f32_flash_ms" if dt == "float32" else "f32_flash_bf16_ms"
            res[name] = graph_ms(lambda: FA.flash_attention(q, k, v))
    q, k, v = qkv(32, 8, 4096, 128, torch.bfloat16)
    res["dpa_flash_ms"] = graph_ms(lambda: FA.dpa_flash_attention(
        q, k, v, fmt="fp8_e4m3", fmt_kv="fp4_e2m1"))
    for name, H, KV, hd in PAGED_CASES:
        args = paged_inputs(gen, H, KV, hd)
        kw = dict(fmt="fp8_e4m3", fmt_kv="fp4_e2m1", kv_packed=True)
        out = PD.paged_decode_attention(*args, **kw)
        torch.save(out.cpu(), OUT / f"{tag}_paged_{name}.pt")
        res[f"paged_{name}_ms"] = graph_ms(
            lambda: PD.paged_decode_attention(*args, **kw))
    for M, K in QUANT_SHAPES:
        x = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        for fmt in QUANT_FMTS:
            def quant(fmt=fmt):
                return QZ.quantize_pack_rows(x) if fmt == "packed" else \
                    QZ.quantize_rows(x, fmt=fmt)
            q, s = quant()
            torch.save((q.view(torch.uint8).cpu(), s.cpu()),
                       OUT / f"{tag}_quant_{M}_{K}_{fmt}.pt")
            res[f"quant_{M}x{K}_{fmt}_ms"] = graph_ms(quant)
    print(json.dumps(res), flush=True)


def paged_inputs(gen, H, KV, hd):
    """One decode step's operands: a packed-fp4 paged cache holding
    PAGED_LENGTHS rows per request (pages of 16), bf16 queries at the
    last row."""
    import torch
    from repro_torch.core import kvcache as KVC
    B, S = len(PAGED_LENGTHS), 256
    k, v = (torch.randn((B, S, KV, hd), generator=gen, device="cuda")
            for _ in range(2))
    kw = dict(fmt="fp4_e2m1", packed=True)
    cache = KVC.paged_from_contiguous(
        KVC.update_kv_cache(KVC.init_kv_cache(B, S, KV, hd, device="cuda",
                                              **kw), k, v, 0, **kw),
        list(PAGED_LENGTHS), page_size=16)
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(
        torch.bfloat16)
    pos = torch.tensor([n - 1 for n in PAGED_LENGTHS], dtype=torch.int32,
                       device="cuda")
    return (q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
            cache["v_scale"], cache["block_table"], pos)


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
    diff = {}
    for H, KV, S, hd, dt in F32_CASES:
        name = f"f32_{H}_{S}_{hd}_{dt}"
        a, b = (torch.load(OUT / f"{t}_{name}.pt").float()
                for t in ("other", "this"))
        err = (a - b).abs()
        big = float(a.abs().max())
        if dt == "float32":
            ok = float(err.max()) <= FLASH_F32_RTOL * big
        else:       # one bf16 ulp of the other side's output over the pin
            _, e = torch.frexp(a)
            ok = bool((err <= torch.ldexp(torch.ones_like(a), e - 8)
                       + FLASH_F32_RTOL * big).all())
        diff[name] = {"max_abs": float(err.max()),
                      "max_rel": float(err.max()) / big,
                      "differ": int((err > 0).sum()), "within_pin": ok}
    for name, *_ in PAGED_CASES:
        a, b = (torch.load(OUT / f"{t}_paged_{name}.pt").float()
                for t in ("other", "this"))
        err = float((a - b).abs().max())
        diff[f"paged_{name}"] = {"max_abs": err,
                                 "within_pin": err <= PAGED_DECODE_CARD_TOL}
    for M, K in QUANT_SHAPES:
        for fmt in QUANT_FMTS:
            a, b = (torch.load(OUT / f"{t}_quant_{M}_{K}_{fmt}.pt")
                    for t in ("other", "this"))
            diff[f"quant_{M}x{K}_{fmt}"] = {
                "within_pin": all(torch.equal(u, v) for u, v in zip(a, b))}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"the two sides' outputs: {diff}")
    print(card)
    print(json.dumps({"card": card, "other": str(other), "this": str(this),
                      "ms": runs, "diff": diff}))


if __name__ == "__main__":
    main()
