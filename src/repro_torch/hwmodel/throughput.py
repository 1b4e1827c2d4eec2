"""Throughput / area-efficiency model — Table I, Table II, Fig. 1, Fig. 7a.

The execution contract per mode:

  FPnew (baseline): scalar FMA and packed-SIMD FMA at format width, but
  any *trans-precision* accumulation (low-precision product into FP32)
  issues ONE FMA per cycle — the fixed-width output interface can retire
  only a single high-precision result (paper Fig. 1).

  TransDot: adds N-term DPA (Table I), retiring N MACs per cycle into a
  single FP32/FP16 result through the same interface.

Area efficiency (Fig. 7a) = throughput ratio / area ratio.
"""
from __future__ import annotations

import dataclasses

from .area import (TRANSDOT_AREA_RATIO_MEAN, TRANSDOT_AREA_RATIO_RANGE,
                   transdot_area_ratio)

CLOCK_GHZ = 1.0          # paper's synthesis point
LATENCY_CYCLES = 4       # Table II "Lat"
DPA_EXTRA_STAGE = 1      # §III-B / abstract: +1 pipeline stage in DPA mode


@dataclasses.dataclass(frozen=True)
class Mode:
    name: str
    fmt: str
    kind: str            # "scalar" | "simd" | "dpa"
    ways: int            # lanes (simd) or terms (dpa)
    acc_fmt: str


# Table I (+ Table II rows)
MODES = [
    Mode("fp32_fma_scalar", "fp32", "scalar", 1, "fp32"),
    Mode("fp16_fma_scalar", "fp16", "scalar", 1, "fp16"),
    Mode("fp16_fma_simd", "fp16", "simd", 2, "fp16"),
    Mode("fp16_dpa_fp32", "fp16", "dpa", 2, "fp32"),
    Mode("fp8_fma_scalar", "fp8_e4m3", "scalar", 1, "fp8_e4m3"),
    Mode("fp8_fma_simd", "fp8_e4m3", "simd", 4, "fp8_e4m3"),
    Mode("fp8_dpa_fp32", "fp8_e4m3", "dpa", 4, "fp32"),
    Mode("fp4_dpa_fp32", "fp4_e2m1", "dpa", 8, "fp32"),
]
MODE_BY_NAME = {m.name: m for m in MODES}


def macs_per_cycle(mode: Mode, unit: str = "transdot") -> int:
    """MAC throughput of one FPU issue port."""
    if unit == "transdot":
        return mode.ways
    # FPnew: no DPA; trans-precision accumulate serializes to 1/cycle
    if mode.kind == "dpa":
        return 1
    return mode.ways


def gflops(mode: Mode, unit: str = "transdot") -> float:
    """Table II 'Perf' column: 2 FLOP per MAC at 1 GHz."""
    return 2.0 * macs_per_cycle(mode, unit) * CLOCK_GHZ


def latency_cycles(mode: Mode) -> int:
    return LATENCY_CYCLES  # Table II: 4 for every mode (DPA stage retimed)


def area_efficiency(mode: Mode, *, area_ratio: float = None) -> float:
    """Throughput/area of TransDot relative to FPnew for this mode."""
    r = area_ratio if area_ratio is not None else TRANSDOT_AREA_RATIO_MEAN
    return (macs_per_cycle(mode, "transdot")
            / macs_per_cycle(mode, "fpnew")) / r


def area_efficiency_range(mode: Mode):
    lo, hi = TRANSDOT_AREA_RATIO_RANGE
    return (area_efficiency(mode, area_ratio=hi),
            area_efficiency(mode, area_ratio=lo))


def area_efficiency_at_delay(mode: Mode, delay_ns: float) -> float:
    return area_efficiency(mode, area_ratio=transdot_area_ratio(delay_ns))


# -----------------------------------------------------------------------------
# DPA term-count scale: each format's terms per issued operation against
# a 2-term (bf16 / fp16) row, the paper's Fig. 1 scaling of FPU
# throughput.  It is a property of the paper's datapath, not a device
# rate: the port's roofline takes the H100's peaks per format from
# `kernels.census`.
# -----------------------------------------------------------------------------

PEAK_SCALE_VS_BF16 = {"fp32": 0.5, "bf16": 1.0, "fp16": 1.0,
                      "fp8_e4m3": 2.0, "fp8_e5m2": 2.0, "fp4_e2m1": 4.0}


def peak_flops_scale(fmt_name: str) -> float:
    return PEAK_SCALE_VS_BF16[fmt_name]
