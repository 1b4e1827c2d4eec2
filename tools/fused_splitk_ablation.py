"""Where the split-K fused kernel's time goes: ablations on the card.

    python3 tools/fused_splitk_ablation.py

Builds `src/repro_torch/csrc/dpa_matmul.cuh` and its sources (with
`dpa_mma.cuh` pasted in)
several ways into `build/fused_splitk_ablation/`:
- as it is ("full");
- stubs: the packed E2M1 -> f16x2 weight decode a pass-through
  ("nodecode"); the MMA an xor that keeps its inputs live ("nomma"); the
  split's partial sums kept by each rank, not pushed to the owner
  ("noexchange"); no activation prologue, x neither read nor quantized
  ("noquant"); no weight copies ("noload"); decode, MMA and prologue all
  out ("skeleton": launch, ring, fold, exchange, epilogue);
- probes: the prologue alone, no weights and no main loop ("prologue"),
  without its x loads ("prologue_noxload"), and neither ("empty":
  launch, barriers, exchange, epilogue); the absmax shuffles replaced by a
  register op ("noshfl");
- the choices not taken: each block quantizing its own rows instead of
  sharing them over the cluster's column tiles ("noshare"), or sharing
  them over as many as fit, also where every block has a single lockstep
  round of pairs and the grid fills the SMs ("shareall"); every quotient through
  __fdiv_rn ("exactdiv"); eight warps a block ("warps8", another fold);
  deeper weight rings ("deeper"); 16 pairs a warp in the prologue's
  lockstep, not 8 ("unroll16").
Each times the calls of one qwen3-4b decode layer (its seven projections
at M = 8, 4 live rows and 4 zero rows as the engine pads them, packed-fp4
weights, the launch plan of `kernels.dpa_matmul.fused_plan`) and of one
granite-moe-1b expert layer (E 32, M = 8, as padded) and attention layer,
warm, each call as
the device time of a CUDA-graph replay of 20 copies (no host gaps between
the launches), and their sum.  The variants that compute the function are
checked against the plain version; the stubs compute garbage on purpose.
Needs a CUDA card and nvcc; prints the card's name and power limit and
one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

M = 8
LIVE = 4          # an engine decode step: 4 live rows, padded to 8
# qwen3-4b: wq, wk, wv, wo, wg, wu, wd; granite-moe-1b experts: wg, wu,
# wd, and its attention: wq, wk, wv, wo
LAYERS = {"qwen3-4b decode layer": [(1, 2560, 4096), (1, 2560, 1024),
                                    (1, 2560, 1024), (1, 4096, 2560),
                                    (1, 2560, 9728), (1, 2560, 9728),
                                    (1, 9728, 2560)],
          "granite expert layer": [(32, 1024, 512), (32, 1024, 512),
                                   (32, 512, 1024)],
          "granite attention layer": [(1, 1024, 1024), (1, 1024, 512),
                                      (1, 1024, 512), (1, 1024, 1024)]}
REPS = 20
DECODE = "  constexpr uint32_t kLut0"
MMA = '  asm("mma.sync.aligned.m16n8k16'
MMA_STUB = ("  c[0] = __int_as_float(__float_as_int(c[0]) ^ a0 ^ b0 ^ a2);\n"
            "  c[1] = __int_as_float(__float_as_int(c[1]) ^ a1 ^ b1 ^ a3);\n")
NOQUANT = ("p0 < P; p0 += step", "p0 < 0; p0 += step")
NOLOAD = ("    if (i < nst) {\n      const int j",
          "    if (i < 0) {\n      const int j")
WARPS8 = ("constexpr int kWarps = 4;", "constexpr int kWarps = 8;")
NOXLOAD = ("        dpa::load4(x + (size_t)(m0 + r) * K + kbeg + j * kBK + "
           "4 * lane,\n                   v[u]);",
           "        v[u][0] = lane, v[u][1] = p, v[u][2] = r, v[u][3] = j;")
EXACTDIV = ("quantize4<XB>(v[u], sc[u], rcp_refined(sc[u]), xfmt, false);",
            "quantize4<XB>(v[u], sc[u], 0.0f, xfmt, true);")
PROLOGUE = ("  const int nst = (warp < L ?",
            "  const int nst = 0 * (warp < L ?")
NOSHFL = ("        a[u] = fmaxf(a[u], __shfl_xor_sync(0xffffffffu, a[u], o));",
          "        a[u] = fmaxf(a[u], __int_as_float(o));")
UNROLL16 = ("constexpr int kQuantUnroll = 8;",
            "constexpr int kQuantUnroll = 16;")
DEEPER = ("  return bn == 32 ? 4 : 3;", "  return bn == 32 ? 6 : 4;")
NOEXCHANGE = (("dst = cluster.map_shared_rank(dst, tile_c * split + owner);",
               "dst = dst;"),)
NOSHARE = ("  while (2 * cn * split <= 8 &&", "  while (false &&")
SHAREALL = ("         (pairs > cn * kWarps * kQuantUnroll || blocks < sms))",
            "         true)")


def _replace(text: str, pairs) -> str:
    for a, b in pairs:
        text.index(a)
        text = text.replace(a, b)
    return text


def _stub_mma(text: str) -> str:
    at = text.index(MMA)
    end = text.index('"r"(b0), "r"(b1));', at) + len('"r"(b0), "r"(b1));')
    return text[:at] + MMA_STUB + text[end:]


def _no_decode(text: str) -> str:
    text.index(DECODE)
    return text.replace(DECODE, "  out[0] = w, out[1] = w >> 8, out[2] = "
                        "w >> 16, out[3] = w >> 24;\n  return;\n" + DECODE)


def variants(src: str) -> dict:
    """The source as it is and with parts stubbed (each `index` raises if
    the source no longer has the stubbed code)."""
    return {"full": src, "nodecode": _no_decode(src),
            "nomma": _stub_mma(src),
            "noexchange": _replace(src, NOEXCHANGE),
            "noshare": _replace(src, (NOSHARE,)),
            "shareall": _replace(src, (SHAREALL,)),
            "exactdiv": _replace(src, (EXACTDIV,)),
            "noquant": _replace(src, (NOQUANT,)),
            "noload": _replace(src, (NOLOAD,)),
            "warps8": _replace(src, (WARPS8,)),
            "deeper": _replace(src, (DEEPER,)),
            "unroll16": _replace(src, (UNROLL16,)),
            "prologue": _replace(src, (PROLOGUE,)),
            "prologue_noxload": _replace(src, (PROLOGUE, NOXLOAD)),
            "empty": _replace(src, (PROLOGUE, NOQUANT)),
            "noshfl": _replace(src, (NOSHFL,)),
            "skeleton": _replace(_stub_mma(_no_decode(src)), (NOQUANT,))}


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build
    sys.path.insert(0, str(ROOT / "tools"))
    from fused_tiled_ablation import inline_mma_header
    # the kernel's header with the entry and the fp16 instances after it:
    # one source to stub and build
    inc = '#include "dpa_matmul.cuh"\n'
    src = inline_mma_header(
        (build.CSRC / "dpa_matmul.cuh").read_text()
        + "".join((build.CSRC / f).read_text().replace(inc, "")
                  for f in ("dpa_matmul.cu", "dpa_matmul_x16.cu")))
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants(src).items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-shared", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fn = lib.dpa_grouped_fused_launch
        fn.argtypes = list(build._SIGNATURES["dpa_grouped_fused_launch"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def graph_layer_ms(layer) -> float:
    """CUDA-event time of one replay of REPS calls of `layer` captured in
    a CUDA graph, per call."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        layer()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            layer()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_splitk_ablation: no CUDA device")
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_grouped_weights
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "fused_splitk_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
    res = {}
    for what, shapes in LAYERS.items():
        calls = []
        for E, K, N in shapes:
            w = torch.randn((E, K, N), generator=gen,
                            device="cuda") * K ** -0.5
            prep = prep_grouped_weights(w, "w4a8_kv4_attn8")
            x = torch.randn((E, M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            x[:, LIVE:] = 0          # the decode step's padding
            calls.append((x, prep, torch.empty((E, M, N), device="cuda"),
                          DM.fused_plan(E, M, K, N), E, K, N))
        res[what] = {}
        for name, fn in libs.items():
            def launch(c, fn=fn):
                x, prep, out, p, E, K, N = c
                err = fn(x.data_ptr(), 1, 0, prep["wq"].data_ptr(), 0,
                         prep["sw"].data_ptr(), out.data_ptr(), E, M, K, N,
                         p.bm, p.bn, p.split,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            try:
                for c in calls:
                    launch(c)
            except RuntimeError as e:   # a variant the launch refuses
                print(f"{what}, {name}: refused ({e})")
                res[what][name] = None
                continue
            torch.cuda.synchronize()
            if name in ("full", "noshare", "shareall", "warps8", "deeper",
                        "unroll16", "exactdiv"):
                for x, prep, out, _, _, _, _ in calls:
                    want = GM.dpa_grouped_matmul_fused_ref(x, prep["wq"],
                                                           prep["sw"], **kw)
                    if not bool(((out - want).abs()
                                 <= 2e-4 + 2e-5 * want.abs()).all()):
                        raise AssertionError(f"{name} {what} differs")
            per_call = [graph_layer_ms(lambda c=c: launch(c)) for c in calls]
            res[what][name] = {"layer": sum(per_call), "per_call": per_call}
            print(f"{what}, {name}: {sum(per_call):.5f} ms per layer (M={M},"
                  " graph replay); per call " + ", ".join(
                      f"{E}x{K}x{N} {t * 1e3:.2f} us" for t, (E, K, N)
                      in zip(per_call, shapes)))
    print(card)
    print(json.dumps({"card": card, "ms_per_layer": res}))


if __name__ == "__main__":
    main()
