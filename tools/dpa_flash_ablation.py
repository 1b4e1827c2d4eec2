"""Where the DPA flash kernel's time goes: ablations on the card.

    python3 tools/dpa_flash_ablation.py

Builds `src/repro_torch/csrc/dpa_flash.cu` several ways into
`build/dpa_flash_ablation/`: as it is ("full"); with one stage cut at a
time — QK over one of its hd / 16 k-steps ("qk1": 7/8 of its MMAs and
fragment loads out), PV over one of its eight 16-key chunks ("pv1": 7/8
of its MMAs, V fragment loads and p splits out); the exp ("noexp"), the
p quantization (division and E4M3 rounding, "noquant") or both
("nosoftmax"); the cp.async copies of the K/V code rows ("noload") or
their widening into the fp16 tiles ("nowiden"); qk1, pv1 and nosoftmax
together ("skeleton"); and the second fp16 piece of the scaled p
("onepiece": PV's MMAs halved, the split kept).  Each times one
qwen3-4b scoring layer (S 4096, H 32, KV 8, hd 128, causal, bf16 q,
packed-fp4 K/V codes made by the pre-pass beforehand) as a CUDA-graph
replay of 10 calls; the pre-pass alone (`quantize_pack_rows` on K and
V) is timed the same way with the package's own library.  Only "full"
is checked against the plain version: the others compute garbage on
purpose.  Needs a CUDA card and nvcc; prints the card's name and power
limit and one JSON line.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

H, KV, S, HD = 32, 8, 4096, 128
CALLS = 10
EXP = "s[n][e] = expf(s[n][e] - m_cur[e >> 1]);"
QUANT = """      const float y = kExact ? __fdiv_rn(s[n][e], ps[e >> 1])
                             : dpa::quotient(s[n][e], ps[e >> 1], rp[e >> 1]);
      s[n][e] = round_e4m3_pos(fminf(y, dpa::kE4M3Max));"""
QK = "for (int kk = 0; kk < kKSteps; ++kk) {"
PV = "for (int c = 0; c < kT / 16; ++c) {"
STUBS = {
    "qk1": [(QK, "for (int kk = 0; kk < 1; ++kk) {")],
    "pv1": [(PV, "for (int c = 0; c < 1; ++c) {")],
    "noexp": [(EXP, "s[n][e] = __fsub_rn(s[n][e], m_cur[e >> 1]);")],
    "noquant": [(QUANT, "      s[n][e] = __fmul_rn(s[n][e], ps[e >> 1]);")],
    "noload": [("  load_stage<HD, FMT>(p, sm, kv_row0, j0 * bk);",
                "  if (false) load_stage<HD, FMT>(p, sm, kv_row0, 0);"),
               ("if (j0 + 1 < j1) load_stage", "if (false) load_stage"),
               ("if (j + 2 < j1) load_stage", "if (false) load_stage")],
    "nowiden": [("      widen_stage<HD, FMT>(sm, set ^ 1);\n", "")],
    "onepiece": [("constexpr int kPieces = 2;", "constexpr int kPieces = 1;")],
}
STUBS["nosoftmax"] = STUBS["noexp"] + STUBS["noquant"]
STUBS["skeleton"] = STUBS["qk1"] + STUBS["pv1"] + STUBS["nosoftmax"]
# every variant instantiates only the timed kernel (hd 128, bf16 q, packed
# E2M1 codes): one instance to compile instead of twelve
ONLY = [("""  return hd == 64 ? launch_fmt<64, QT>(fmt, p, B, s)
                  : launch_fmt<128, QT>(fmt, p, B, s);""",
         "  return launch<128, QT, kPackedE2M1>(p, B, s);"),
        (": launch_hd<float>(hd, kv_fmt, p, B, s)",
         ": cudaErrorInvalidValue")]


def variants(src: str) -> dict:
    """The source as it is and with stages taken out (each `index` raises
    if the source no longer has the replaced code)."""
    for a, b in ONLY:
        src.index(a)
        src = src.replace(a, b)
    out = {"full": src}
    for name, edits in STUBS.items():
        text = src
        for a, b in edits:
            text.index(a)
            text = text.replace(a, b)
        out[name] = text
    return out


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build
    src = (build.CSRC / "dpa_flash.cu").read_text()
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
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"{name}: {regs[:2]}")
        fn = ctypes.CDLL(str(so)).dpa_flash_launch
        fn.argtypes = list(build._SIGNATURES["dpa_flash_launch"])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def graph_ms(fn) -> float:
    """CUDA-event time per call of a CUDA-graph replay of CALLS calls."""
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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("dpa_flash_ablation: no CUDA device")
    from repro_torch.kernels import flash_attention as FA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "dpa_flash_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, h, S, HD), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (H, KV, KV))
    (kc, ks), (vc, vs) = FA._prepass(k, "fp4_e2m1"), FA._prepass(v,
                                                                 "fp4_e2m1")
    out = torch.empty_like(q)
    res = {"prepass": graph_ms(lambda: (FA._prepass(k, "fp4_e2m1"),
                                        FA._prepass(v, "fp4_e2m1")))}
    for name, fn in libs.items():
        def call(fn=fn):
            err = fn(q.data_ptr(), 1, kc.data_ptr(), vc.data_ptr(),
                     ks.data_ptr(), vs.data_ptr(), out.data_ptr(), None, HD,
                     2, 1, H, KV, S, S, 128, 128, 1, 0, HD ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if name == "full":
            want = FA.dpa_flash_attention_ref(q, k, v, fmt="fp8_e4m3",
                                              fmt_kv="fp4_e2m1")
            if not torch.equal(out, FA.dpa_flash_attention(
                    q, k, v, fmt="fp8_e4m3", fmt_kv="fp4_e2m1")):
                raise AssertionError("full differs from the package's kernel")
            err = float((out.float() - want.float()).abs().max())
            print(f"full: max |diff| vs the plain version {err:.3g}")
        res[name] = graph_ms(call)
        print(f"{name}: {res[name]:.4f} ms per qwen3-4b layer (S={S}, "
              "kernel only)")
    print(card)
    print(json.dumps({"card": card, "ms_per_layer": res}))


if __name__ == "__main__":
    main()
