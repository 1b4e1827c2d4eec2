"""Energy model — Table II (post-PnR, 12 nm, 1 GHz, 0.8 V, TT corner).

The measured pJ/FLOP anchors are the model; derived quantities (per-op
energy, efficiency ratios, energy of a GEMM under a policy) are computed
from them.  This is the deployment-facing face of the paper's energy
claim: FP8 DPA costs 0.84 pJ/FLOP vs 3.75 for FP32 scalar — 4.5x — and
FP4 DPA reaches 9.1x.
"""
from __future__ import annotations

from .throughput import MODE_BY_NAME, Mode, gflops

# Table II, column "Energy (pJ/FLOP)"
ENERGY_PJ_PER_FLOP = {
    "fp32_fma_scalar": 3.75,
    "fp16_fma_scalar": 2.76,
    "fp16_fma_simd": 1.85,
    "fp16_dpa_fp32": 1.80,
    "fp8_fma_scalar": 2.21,
    "fp8_fma_simd": 0.84,
    "fp8_dpa_fp32": 0.84,
    "fp4_dpa_fp32": 0.41,
}

# policy format -> Table II DPA mode used for deployment-energy estimates
_POLICY_MODE = {"fp32": "fp32_fma_scalar", "fp16": "fp16_dpa_fp32",
                "bf16": "fp16_dpa_fp32", "fp8_e4m3": "fp8_dpa_fp32",
                "fp8_e5m2": "fp8_dpa_fp32", "fp4_e2m1": "fp4_dpa_fp32"}


def energy_per_flop(mode_name: str) -> float:
    return ENERGY_PJ_PER_FLOP[mode_name]


def energy_per_op(mode_name: str) -> float:
    """pJ per issued FPU op (an op retires 2*ways FLOPs)."""
    mode: Mode = MODE_BY_NAME[mode_name]
    return ENERGY_PJ_PER_FLOP[mode_name] * gflops(mode) / 1.0  # 1 GHz -> per ns


def efficiency_vs_fp32(mode_name: str) -> float:
    return ENERGY_PJ_PER_FLOP["fp32_fma_scalar"] / ENERGY_PJ_PER_FLOP[mode_name]


def gemm_energy_mj(m: int, k: int, n: int, fmt_name: str) -> float:
    """Energy (mJ) of an (m,k)x(k,n) GEMM executed in the given DPA mode."""
    flops = 2.0 * m * k * n
    return flops * ENERGY_PJ_PER_FLOP[_POLICY_MODE[fmt_name]] * 1e-9
