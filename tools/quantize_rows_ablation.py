"""Where the row quantizers' time goes: ablations on the card.

    python3 tools/quantize_rows_ablation.py

Builds `src/repro_torch/csrc/quantize_rows.cu` several ways into
`build/quantize_rows_ablation/`: as it is ("full"); with the IEEE
division replaced by a multiply ("mul": timing only, the codes change);
with the casts replaced by bit shifts ("nocast": E4M3 / E5M2 pairs and
the E2M1 threshold bisection); with the code stores skipped behind a test
the compiler cannot decide ("nostore": the casts stay live); with the
row read twice, once for the absmax and once to quantize, as the parent
kernel did ("reread"); with room for eight chunks a thread instead of
four ("vecs8": more registers a thread; timed at the plan's split and at
eight chunks a thread); with E2M1 encoded by dpa::encode_fp4's chain of
seven compares instead of the bisection ("chain"), or clipped to +-6
before it ("clip"), as the parent did; and all of mul, nocast and
nostore ("skeleton": the loads, the absmax and its reduction).  Each is timed as a CUDA-graph
replay of 20 calls at qwen3-4b's MLP activations (4096 x 9728 bf16) and
at path D's K/V pre-pass rows (32,768 x 128 bf16), to E4M3 and to
packed E2M1, with the plan of `kernels.quantize.quantize_plan`; "full"
is also timed at other (lanes, chunks a thread) splits of the same rows
(the evidence for the plan's aim).  Only "full" is checked against the
plain version (bit for bit): the others compute garbage on purpose.
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

CALLS = 20
SHAPES = ((4096, 9728), (32768, 128))
FMTS = (("fp8_e4m3", 0), ("packed", 2))
DIV = "__fdiv_rn(x, scale)"
CAST_FP8 = """return __nv_cvt_float2_to_fp8x2(make_float2(a, b), __NV_SATFINITE,
                                    FMT == kQE4M3 ? __NV_E4M3 : __NV_E5M2);"""
CAST_FP4 = """  const uint32_t c = (hi ? 4u : 0u) + (mid ? 2u : 0u) + (a > t ? 1u : 0u);
  return c | (y < 0.0f ? 8u : 0u);"""
PUT = "__device__ __forceinline__ void put(void* p, const uint32_t* w) {\n"
REREAD = "if (tiles > 1) {"
BISECT = """  const float a = fabsf(y);
  const bool hi = a >= 1.75f;"""
NOCLIP = "  if constexpr (FMT == kQE2M1 || FMT == kQE2M1Packed) return y;\n"
VECS = "constexpr int kMaxVecs = 4;"
STUBS = {
    "mul": [(DIV, "__fmul_rn(x, scale)")],
    "nocast": [(CAST_FP8, "return (__float_as_uint(a) >> 24) | "
                          "((__float_as_uint(b) >> 24) << 8);"),
               (CAST_FP4, "  return __float_as_uint(y) >> 28;")],
    "nostore": [(PUT, PUT + "  if (reinterpret_cast<uintptr_t>(p) != 1) "
                            "return;\n")],
    "reread": [(REREAD, "if (tiles > 0) {")],
    "vecs8": [(VECS, "constexpr int kMaxVecs = 8;")],
    "chain": [(BISECT, "  return dpa::encode_fp4(y);\n" + BISECT)],
    "clip": [(NOCLIP, "")],
}
STUBS["skeleton"] = STUBS["mul"] + STUBS["nocast"] + STUBS["nostore"]


def variants(src: str) -> dict:
    """The source as it is and with parts taken out (each `index` raises
    if the source no longer has the replaced code)."""
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
    src = (build.CSRC / "quantize_rows.cu").read_text()
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
        if name == "full":
            for ln in log.splitlines():
                if "registers" in ln or "spill" in ln:
                    print("  " + ln.strip())
        fn = ctypes.CDLL(str(so)).quantize_rows_launch
        fn.argtypes = list(build._SIGNATURES["quantize_rows_launch"])
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


def splits(K: int, width: int, aims=None):
    """(lanes, rows, nv) of the plan's rule with each aim of chunks a
    thread (default 1 to `MAX_VECS`; one tile, at most 1024 lanes)."""
    from repro_torch.kernels.quantize import MAX_VECS
    chunks = -(-K // width)
    out = []
    for aim in aims or range(1, MAX_VECS + 1):
        need = -(-chunks // aim)
        lanes = 1 << (need - 1).bit_length() if need <= 32 else \
            32 * -(-need // 32)
        s = (lanes, 128 // lanes if lanes <= 32 else 1, -(-chunks // lanes))
        if lanes <= 1024 and s not in out:
            out.append(s)
    return out


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("quantize_rows_ablation: no CUDA device")
    from repro_torch.kernels import quantize as QZ
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "quantize_rows_ablation")
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for M, K in SHAPES:
        x = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        plan = QZ.quantize_plan(M, K, x.dtype, "fp8_e4m3")
        scales = torch.empty((M, 1), dtype=torch.float32, device="cuda")
        for fmt, code in FMTS:
            codes = torch.empty((M, K // 2 if code == 2 else K),
                                dtype=torch.uint8, device="cuda")

            def call(fn, lanes=plan.lanes, rows=plan.rows, nv=plan.nv):
                err = fn(x.data_ptr(), 1, codes.data_ptr(),
                         scales.data_ptr(), M, K, code, 1, lanes, rows, nv,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"CUDA error {err}")
            call(libs["full"])
            torch.cuda.synchronize()
            wq, ws = (QZ.quantize_pack_rows_ref(x) if code == 2 else
                      QZ.quantize_rows_ref(x, fmt=fmt))
            if not (torch.equal(codes, wq.view(torch.uint8))
                    and torch.equal(scales, ws)):
                raise AssertionError(f"full {fmt} {M}x{K}: differs from "
                                     "the plain version")
            case = f"{M}x{K} {fmt}"
            res[case] = {name: graph_ms(lambda fn=fn: call(fn))
                         for name, fn in libs.items()}
            res[case]["splits"] = {
                f"lanes {lanes} nv {nv}": graph_ms(
                    lambda s=(lanes, rows, nv): call(libs["full"], *s))
                for lanes, rows, nv in splits(K, plan.width)}
            lanes, rows, nv = splits(K, plan.width, aims=(8,))[0]
            res[case][f"vecs8 lanes {lanes} nv {nv}"] = graph_ms(
                lambda: call(libs["vecs8"], lanes, rows, nv))
            print(f"{case} (plan lanes {plan.lanes} nv {plan.nv}): " +
                  ", ".join(f"{k} {v:.4f}" for k, v in res[case].items()
                            if k != "splits"), flush=True)
            print("  splits: " + ", ".join(
                f"{k}: {v:.4f}" for k, v in res[case]["splits"].items()))
    print(card)
    print(json.dumps({"card": card, "calls": CALLS, "ms": res}))


if __name__ == "__main__":
    main()
