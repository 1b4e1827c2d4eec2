"""Floating-point format descriptors (TransDot Table I plus BF16/E5M2).

    FP32  E8M23   IEEE-754 binary32
    FP16  E5M10   IEEE-754 binary16
    BF16  E8M7    bfloat16
    FP8   E4M3    OCP FP8 E4M3 ("fn": no infinities, NaN = S.1111.111)
    FP8   E5M2    OCP FP8 E5M2 (IEEE-like specials)
    FP4   E2M1    OCP FP4 E2M1 (no infinities, no NaN)

Port of `repro.core.formats`' descriptor table; the bit-level golden-model
decode/encode stays with the reference until the golden model is ported.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    name: str
    exp_bits: int
    man_bits: int
    has_inf: bool = True
    # "ieee": exp==all-ones encodes inf (mant==0) / NaN (mant!=0)
    # "fn":   no inf; only exp==all-ones & mant==all-ones is NaN (OCP E4M3)
    # "none": every code is finite (OCP E2M1)
    special: str = "ieee"

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def precision(self) -> int:
        return self.man_bits + 1

    @property
    def emin(self) -> int:
        return 1 - self.bias

    @property
    def emax(self) -> int:
        if self.special == "ieee":
            return (1 << self.exp_bits) - 2 - self.bias
        return (1 << self.exp_bits) - 1 - self.bias

    @property
    def max_finite(self) -> float:
        if self.special == "ieee":
            frac = 2.0 - 2.0 ** (-self.man_bits)
        elif self.special == "fn":
            frac = 2.0 - 2.0 ** (-self.man_bits) * 2.0
        else:
            frac = 2.0 - 2.0 ** (-self.man_bits)
        return frac * 2.0 ** self.emax

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.emin - self.man_bits)

    @property
    def quant_target(self) -> float:
        """absmax target for quantization scaling, capped at 2^14 so that
        wide-range formats (bf16/fp16) cannot push fp32-accumulated dot
        products into overflow; narrow formats use their full range (fp8
        448, fp4 6)."""
        return min(self.max_finite, 2.0 ** 14)

    @property
    def exp_mask(self) -> int:
        return (1 << self.exp_bits) - 1

    @property
    def man_mask(self) -> int:
        return (1 << self.man_bits) - 1


FP32 = FloatFormat("fp32", 8, 23)
FP16 = FloatFormat("fp16", 5, 10)
BF16 = FloatFormat("bf16", 8, 7)
FP8_E4M3 = FloatFormat("fp8_e4m3", 4, 3, has_inf=False, special="fn")
FP8_E5M2 = FloatFormat("fp8_e5m2", 5, 2)
FP4_E2M1 = FloatFormat("fp4_e2m1", 2, 1, has_inf=False, special="none")

FORMATS = {f.name: f for f in (FP32, FP16, BF16, FP8_E4M3, FP8_E5M2, FP4_E2M1)}
FORMATS.update({"fp8": FP8_E4M3, "fp4": FP4_E2M1})


def get_format(name) -> FloatFormat:
    if isinstance(name, FloatFormat):
        return name
    return FORMATS[name]
