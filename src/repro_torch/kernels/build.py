"""Build and load the port's CUDA kernels.

The sources in `repro_torch/csrc/` compile with `nvcc` for `sm_90a` into
one shared library with a plain C interface, loaded with `ctypes` — a
build of seconds, where an extension that includes PyTorch's headers
takes minutes.  The library is built at first use into
`build/repro_torch/<hash of the sources>/` at the repository root and
reused while the sources are unchanged.  Every source compiles in its
own `nvcc` process, all started together, then one link.

There is no fallback: without `nvcc`, or when the build fails, loading
raises.  Only CUDA tensors ever need the library (CPU tensors take the
plain versions), so nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("dpa_matmul.cu", "dpa_fused_tiled.cu", "dpa_prequant.cu",
           "paged_decode.cu", "flash_attention.cu", "dpa_flash.cu",
           "quantize_rows.cu")
HEADERS = ("dpa_common.cuh", "dpa_mma.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, x_bf16, wq, w_fmt, sw, out, E (1 for a dense product), M, K, N,
    # bm, bn, split, stream
    "dpa_grouped_fused_launch": (_P, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _P),
    # x, x_bf16, codes, scales, rows, K, stream
    "dpa_act_quant_launch": (_P, _I, _P, _P, _I, _I, _P),
    # xq, xs, wq, w_fmt, sw, out, E, M, K, N, stream
    "dpa_fused_tiled_launch": (_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P),
    # xq, sx, wq, sw, out, E, M, K, N, bn, split, stream
    "dpa_prequant_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _P),
    # q, q_bf16, kc, ks, vc, vs, table, positions, out,
    # B, H, KV, hd, page, max_pages, kv_fmt, scale, split, stream
    "paged_decode_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _P,
                            _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _I,
                            _P),
    # q, k, v, out, q_bf16, hd, B, H, KV, Sq, Sk, bq, bk, causal, window,
    # scale, stream
    "flash_attention_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _I, ctypes.c_float, _P),
    # x, out, rows, n, stream
    "flash_kv_split_launch": (_P, _P, ctypes.c_longlong, _I, _P),
    # q, q_bf16, k, v, ks, vs, out, p_codes, hd, kv_fmt,
    # B, H, KV, Sq, Sk, bq, bk, causal, window, scale, stream
    "dpa_flash_launch": (_P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _I,
                         ctypes.c_float, _P),
    # x, x_bf16, codes, scales, M, K, fmt, vec, lanes, rows, nv, stream
    "quantize_rows_launch": (_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P),
}

_LIB = None
BUILD_INFO: dict = {}


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of repro_torch are built from source at first use")


def _build(out: Path) -> str:
    """Compile every source in parallel, link, and move the library into
    place atomically.  Returns the compilers' diagnostics (ptxas -v)."""
    nvcc = _nvcc()
    tmp = out.parent / f"tmp.{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        obj = tmp / (name + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs = [], []
    for name, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {name}\n{text}")
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{text}")
        objs.append(str(obj))
    lib_tmp = tmp / "librepro_kernels.so"
    link = subprocess.run([nvcc, "-shared", "-o", str(lib_tmp), *objs],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    (out.parent / "build.log").write_text("\n".join(log))
    os.replace(lib_tmp, out)
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first call; raises on any failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    out = BUILD_ROOT / _source_hash() / "librepro_kernels.so"
    t0 = time.monotonic()
    cached = out.is_file()
    log = "" if cached else _build(out)
    lib = ctypes.CDLL(str(out))
    for fn, args in _SIGNATURES.items():
        getattr(lib, fn).argtypes = list(args)
        getattr(lib, fn).restype = ctypes.c_int
    BUILD_INFO.update(path=str(out), cached=cached, log=log,
                      seconds=time.monotonic() - t0)
    _LIB = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
