"""Where the f32 flash kernel's bf16 instance spends its time: ablations
on the card.

    python3 tools/f32_flash_ablation.py

Builds `src/repro_torch/csrc/flash_attention.cu` several ways into
`build/f32_flash_ablation/`, each with only the tensor-core instance
path C runs (hd 128, bf16): as it is ("full"); with one part cut at a
time — QK's mid and lo pieces ("qk_hi": 2/3 of QK's MMAs out), PV's mid
and lo pieces ("pv_hi"), both ("hi_only": one bf16 product each, as
plain bf16 attention would run them), QK over one of its hd / 16 k-steps
("qk1"), PV over one of its four 16-key chunks ("pv1"), the exp
("noexp"), the three-way split of p (and of q) replaced by one
conversion ("nosplit"), the K/V cp.async copies ("noload"); and qk1,
pv1 and noexp together ("skeleton").  Each times one qwen3-4b prefill
layer (S 4096, H 32, KV 8, hd 128, causal, bf16 q/k/v) as a CUDA-graph
replay of 10 calls.  Only "full" is checked, against the package's own
kernel (the same bits) and the plain version: the others compute
garbage on purpose.  Needs a CUDA card and nvcc; prints the card's name
and power limit and one JSON line.
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
QK_PIECES = ("for (int i = 0; i < T::kLo; ++i) {\n"
             "          const uint32_t(&x)[4] = a[T::lo_a(i)];\n"
             "          const uint32_t(&y)[4] = bf[T::lo_b(i)];\n"
             "          dpa::mma_bf16(sl[")
PV_PIECES = ("for (int i = 0; i < T::kLo; ++i) {\n"
             "            const uint32_t(&x)[4] = a[T::lo_a(i)];\n"
             "            const uint32_t(&y)[4] = bf[T::lo_b(i)];\n"
             "            dpa::mma_bf16(pl[")
SPLIT = """  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(r0, mf.x), __fsub_rn(r1, mf.y));"""
STUBS = {
    "qk_hi": [(QK_PIECES, QK_PIECES.replace("i < T::kLo", "i < 0"))],
    "pv_hi": [(PV_PIECES, PV_PIECES.replace("i < T::kLo", "i < 0"))],
    "qk1": [("for (int kk = 0; kk < kKSteps; ++kk) {",
             "for (int kk = 0; kk < 1; ++kk) {")],
    "pv1": [("for (int c = 0; c < kTN / 16; ++c) {",
             "for (int c = 0; c < 1; ++c) {")],
    "noexp": [("sh[n][e] = expf(sh[n][e] - m_cur[e >> 1]);",
               "sh[n][e] = __fsub_rn(sh[n][e], m_cur[e >> 1]);")],
    "nosplit": [(SPLIT, "  const __nv_bfloat162 m = h, l = h;\n"
                        "  (void)r0, (void)r1;")],
    "noload": [("load_tc_tile<HD, KVP>(p, sm,",
                "if (false) load_tc_tile<HD, KVP>(p, sm,")],
}
STUBS["hi_only"] = STUBS["qk_hi"] + STUBS["pv_hi"]
STUBS["skeleton"] = STUBS["qk1"] + STUBS["pv1"] + STUBS["noexp"]
# every variant instantiates only the timed kernel: one instance to
# compile instead of four
ONLY = [("""  if (q_bf16)
    return (int)(hd == 64 ? launch_tc<64, 1>(p, B, s)
                          : launch_tc<128, 1>(p, B, s));
  return (int)(hd == 64 ? launch_tc<64, 3>(p, B, s)
                        : launch_tc<128, 3>(p, B, s));""",
         "  return q_bf16 && hd == 128 ? (int)launch_tc<128, 1>(p, B, s)\n"
         "                             : (int)cudaErrorInvalidValue;")]


def variants(src: str) -> dict:
    """The source as it is and with parts taken out (each `index` raises
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
    src = (build.CSRC / "flash_attention.cu").read_text()
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
        fn = ctypes.CDLL(str(so)).flash_attention_launch
        fn.argtypes = list(build._SIGNATURES["flash_attention_launch"])
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
        sys.exit("f32_flash_ablation: no CUDA device")
    from repro_torch.kernels import flash_attention as FA
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "f32_flash_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((1, h, S, HD), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (H, KV, KV))
    out = torch.empty_like(q)
    res = {}
    for name, fn in libs.items():
        def call(fn=fn):
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     1, HD, 1, H, KV, S, S, 128, 128, 1, 0, HD ** -0.5,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        call()
        torch.cuda.synchronize()
        if name == "full":
            if not torch.equal(out, FA.flash_attention(q, k, v)):
                raise AssertionError("full differs from the package's kernel")
            want = FA.flash_attention_ref(q, k, v)
            err = float((out.float() - want.float()).abs().max())
            print(f"full: max |diff| vs the plain version {err:.3g}")
        res[name] = graph_ms(call)
        print(f"{name}: {res[name]:.4f} ms per qwen3-4b layer (S={S}, bf16)")
    print(card)
    print(json.dumps({"card": card, "ms_per_layer": res}))


if __name__ == "__main__":
    main()
