"""Where the tiled fused kernel's time goes: ablations on the card.

    python3 tools/fused_tiled_ablation.py

Builds `src/repro_torch/csrc/dpa_fused_tiled.cu` several ways into
`build/fused_tiled_ablation/`: as it is ("full"); with the E4M3 -> f16x2
conversions of the activation fragments replaced by a pass-through
("nocvt"); with the packed E2M1 -> f16x2 weight decode replaced by a
pass-through ("nodecode"); with the MMA replaced by an xor that keeps its
inputs live ("nomma"); with all three ("skeleton": the cp.async ring,
the fragment loads, the barriers, the fold and the epilogue); with no
cp.async at all ("noload"); and the design choices it did not take: a
ring of 2 or 4 stages ("ring2", "ring4"), the grid's rows fastest
("mfast"), and warps of 32 or 16 rows, 16 or 32 of them ("warp32",
"warp16").  Each times the product stage of one qwen3-4b layer at M =
4096 (its seven projections, packed-fp4 weights, the pre-pass run once
beforehand) with CUDA events over 10 layers after warm-up.  Only "full" is checked
against the plain version: the others compute garbage on purpose.  Needs
a CUDA card and nvcc; prints the card's name and power limit and one
JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

M = 4096
# qwen3-4b: wq, wk, wv, wo, wg, wu, wd
LAYER = ((2560, 4096), (2560, 1024), (2560, 1024), (4096, 2560),
         (2560, 9728), (2560, 9728), (9728, 2560))
CVT = "  uint32_t r;\n  const unsigned short h"
DECODE = "  constexpr uint32_t kLut0"
MMA = '  asm("mma.sync.aligned.m16n8k16'
MMA_STUB = ("  c[0] = __int_as_float(__float_as_int(c[0]) ^ a0 ^ b0 ^ a2);\n"
            "  c[1] = __int_as_float(__float_as_int(c[1]) ^ a1 ^ b1 ^ a3);\n")
PROBES = {
    "noload": ("    if (c < nkb) {\n      uint8_t* st",
               "    if (c < 0) {\n      uint8_t* st"),
    "ring2": ("constexpr int kStages = 3;", "constexpr int kStages = 2;"),
    "ring4": ("constexpr int kStages = 3;", "constexpr int kStages = 4;"),
    "warp32": ("constexpr int kMT = 4;", "constexpr int kMT = 2;"),
    "warp16": ("constexpr int kMT = 4;", "constexpr int kMT = 1;"),
}
MFAST = (("const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;",
          "const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;"),
         ("const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, E);",
          "const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, E);"))


def _stub_mma(text: str) -> str:
    at = text.index(MMA)
    end = text.index('"r"(b0), "r"(b1));', at) + len('"r"(b0), "r"(b1));')
    return text[:at] + MMA_STUB + text[end:]


def variants(src: str) -> dict:
    """The source as it is and with parts stubbed (each `index` raises if
    the source no longer has the stubbed code)."""
    src.index(CVT), src.index(DECODE)
    nocvt = src.replace(CVT, "  return v;\n" + CVT)
    nodecode = src.replace(DECODE, "  out[0] = w, out[1] = w >> 8, out[2] = "
                           "w >> 16, out[3] = w >> 24;\n  return;\n" + DECODE)
    skeleton = _stub_mma(nocvt.replace(
        DECODE, "  out[0] = w, out[1] = w >> 8, out[2] = w >> 16, out[3] = "
        "w >> 24;\n  return;\n" + DECODE))
    out = {"full": src, "nocvt": nocvt, "nodecode": nodecode,
           "nomma": _stub_mma(src), "skeleton": skeleton}
    for name, (a, b) in PROBES.items():
        src.index(a)
        out[name] = src.replace(a, b)
    mfast = src
    for a, b in MFAST:
        mfast.index(a)
        mfast = mfast.replace(a, b)
    out["mfast"] = mfast
    return out


def inline_mma_header(src: str) -> str:
    """The source with `dpa_mma.cuh` pasted in place of its include, so
    the stubs reach the conversions and the MMA it defines."""
    from repro_torch.kernels import build
    inc = '#include "dpa_mma.cuh"\n'
    src.index(inc)
    head = (build.CSRC / "dpa_mma.cuh").read_text().replace("#pragma once\n",
                                                            "")
    return src.replace(inc, head)


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build
    src = inline_mma_header((build.CSRC / "dpa_fused_tiled.cu").read_text())
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
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print(f"{name}: {'; '.join(regs)}")
        lib = ctypes.CDLL(str(so))
        fn = lib.dpa_fused_tiled_launch
        fn.argtypes = list(build._SIGNATURES["dpa_fused_tiled_launch"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("fused_tiled_ablation: no CUDA device")
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_weights
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "fused_tiled_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    calls = []
    for K, N in LAYER:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_weights(w.to(torch.bfloat16), "w4a8_kv4_attn8")
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        codes, scales = DM.dpa_act_quant(x)
        out = torch.empty((M, N), device="cuda")
        calls.append((x, codes, scales, prep, out, K, N))
    res = {}
    for name, fn in libs.items():
        def layer(fn=fn):
            for _, codes, scales, prep, out, K, N in calls:
                err = fn(codes.data_ptr(), 0, scales.data_ptr(),
                         prep["wq"].data_ptr(), 0, prep["sw"].data_ptr(),
                         out.data_ptr(), 1, M, K, N, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
        layer()
        torch.cuda.synchronize()
        if name == "full":
            for x, _, _, prep, out, K, N in calls:
                want = DM.dpa_matmul_fused_ref(
                    x, prep["wq"], prep["sw"], fmt_x="fp8_e4m3",
                    fmt_w="fp4_e2m1", pack_w=True)
                if not bool(((out - want).abs()
                             <= 2e-4 + 2e-5 * want.abs()).all()):
                    raise AssertionError(f"full K={K} N={N} differs")
        for _ in range(3):
            layer()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(10):
            layer()
        b.record()
        torch.cuda.synchronize()
        res[name] = a.elapsed_time(b) / 10
        print(f"{name}: {res[name]:.4f} ms per qwen3-4b layer (M={M}, "
              "product stage only)")
    print(card)
    print(json.dumps({"card": card, "ms_per_layer": res}))


if __name__ == "__main__":
    main()
