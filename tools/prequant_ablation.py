"""Where the prequant kernel's time goes: ablations on the card.

    python3 tools/prequant_ablation.py

Builds `src/repro_torch/csrc/dpa_prequant.cu` four ways into
`build/prequant_ablation/`: as it is, with the E2M1 -> int8 decode
replaced by a pass-through ("nodecode"), with the int8 MMA replaced by
an xor-add that keeps its inputs live ("nomma"), and with both
("neither": what is left is the launch, the cp.async ring, the barriers
and the epilogue).  Each is timed on the device (torch.profiler, kernel
time per call) at path B's prequant shapes (granite-moe-1b, M = 8) with
the launch plan of `kernels.dpa_matmul.prequant_plan`, and, for the
grouped shapes, at other column tiles.  Only the unchanged build is
checked against the plain version: the others compute garbage on
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

SHAPES = ((1, 1024, 1024), (1, 1024, 512), (32, 1024, 512), (32, 512, 1024))
MMA_STUB = ("  c[0] += a[0] ^ b0; c[1] += a[1] ^ b1; c[2] += a[2]; "
            "c[3] += a[3];")


def _stub_mma(text: str) -> str:
    at = text.index('  asm volatile(\n      "mma.sync')
    end = text.index('"r"(b0), "r"(b1));', at) + len('"r"(b0), "r"(b1));')
    return text[:at] + MMA_STUB + text[end:]


def variants(src: str) -> dict:
    """The source as it is and with its decode, its MMA or both stubbed
    (each `index` raises if the source no longer has the stubbed code)."""
    dec = "  const uint32_t sel = v & 0x7777u;"
    src.index(dec)
    nodecode = src.replace(dec, "  return v;\n" + dec)
    return {"full": src, "nodecode": nodecode, "nomma": _stub_mma(src),
            "neither": _stub_mma(nodecode)}


def build_all(out: Path) -> dict:
    from repro_torch.kernels import build
    src = (build.CSRC / "dpa_prequant.cu").read_text()
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
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.dpa_prequant_launch.argtypes = [P, I, P, P, I, P, P] + [I] * 6 \
            + [P]
        lib.dpa_prequant_launch.restype = I
        libs[name] = lib
    return libs


def device_us(fn, n: int = 50) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if not spans:
        raise RuntimeError("the profiler recorded no device time")
    return sum(spans) / n


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("prequant_ablation: no CUDA device")
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    libs = build_all(ROOT / "build" / "prequant_ablation")
    gen = torch.Generator(device="cuda").manual_seed(3)
    kw = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True, pack_w=True)
    M, res = 8, {}
    for E, K, N in SHAPES:
        xq = torch.randint(0, 256, (E, M, K // 2), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        wq = torch.randint(0, 256, (E, K // 2, N), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        sx = torch.rand((E, M, 1), generator=gen, device="cuda") + 0.05
        sw = torch.rand((E, 1, N), generator=gen, device="cuda") + 0.05
        want = GM.dpa_grouped_matmul_prequant_ref(xq, wq, sx, sw, **kw)
        out = torch.empty_like(want)
        plan = DM.prequant_plan(E, M, K, N)
        launches = [(plan.bn, plan.split)] + (
            [(bn, 1) for bn in DM.COL_TILES if bn != plan.bn] if E > 1
            else [])
        for bn, split in launches:
            row = {}
            for name, lib in libs.items():
                def call(lib=lib, bn=bn, split=split):
                    err = lib.dpa_prequant_launch(
                        xq.data_ptr(), 0, sx.data_ptr(), wq.data_ptr(), 0,
                        sw.data_ptr(), out.data_ptr(), E, M, K, N, bn, split,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                call()
                torch.cuda.synchronize()
                if name == "full" and not torch.equal(out, want):
                    raise AssertionError(f"E={E} K={K} N={N} bn {bn} split "
                                         f"{split}: differs from the plain "
                                         "version")
                row[name] = device_us(call)
            key = f"E{E} K{K} N{N} bn{bn}/s{split}"
            res[key] = row
            print(f"{key}: " + ", ".join(f"{k} {v:.2f} us"
                                         for k, v in row.items()),
                  flush=True)
    print(json.dumps({"card": card, "device_us_per_call": res}))
    print(card)


if __name__ == "__main__":
    main()
