"""Trans-precision execution policy — the software mode register (a
verbatim copy of `repro.core.policy`, which the port may not import).

A policy names the operand format for weights and activations, the
accumulate format, the scale granularity, and the attention / KV-cache
formats; every DPA-shaped op carries one.
"""
from __future__ import annotations

import dataclasses

from .formats import get_format

# Table I: format -> DPA terms folded into one FP32 accumulation
DPA_TERMS = {"fp32": 1, "bf16": 2, "fp16": 2, "fp8_e4m3": 4, "fp8_e5m2": 4,
             "fp4_e2m1": 8}


@dataclasses.dataclass(frozen=True)
class TransPrecisionPolicy:
    """Per-op trans-precision configuration.

    fmt_weights / fmt_acts: operand formats fed to the multiplier array.
    accum: the accumulate format (Table I column "Accumulate Format").
    granularities: "per_tensor" | "per_channel" | "per_block".
    use_kernel: route through the dpa_matmul kernel.
    packed: move fp4 operand sides as packed bytes (2 E2M1 codes/byte)
    — the paper's format-width I/O contract.  Bit-identical to unpacked.
    fused_quant: quantize activations *inside* the matmul kernel prologue
    (per-(row, K-block) absmax scales folded into the accumulation) —
    no quantized-activation round-trip through device memory.
    fmt_attn: operand format for the attention matmuls (QK^T and PV both
    accumulate in f32 over fmt_attn operands; the online-softmax running
    max/sum stay f32).  "fp32" leaves attention on the seed datapath.
    fmt_kv: storage format of the KV cache ("fp32" = raw compute-dtype
    cache).  K/V are dequantized in the kernel prologue, so a narrow cache
    trades per-row scales for 2x/4x/~8x fewer cache bytes per decode step.
    kv_packed: pack fp4 KV codes two per byte along head_dim
    (`core.packing` nibble layout — bit-identical to unpacked).
    """
    fmt_weights: str = "fp32"
    fmt_acts: str = "fp32"
    accum: str = "fp32"
    w_granularity: str = "per_channel"
    a_granularity: str = "per_tensor"
    block_size: int = 128
    use_kernel: bool = False
    packed: bool = False
    fused_quant: bool = False
    fmt_attn: str = "fp32"
    fmt_kv: str = "fp32"
    kv_packed: bool = False

    def __post_init__(self):
        get_format(self.fmt_weights), get_format(self.fmt_acts)
        get_format(self.fmt_attn), get_format(self.fmt_kv)
        if get_format(self.accum).name not in ("fp32", "fp16"):
            raise ValueError("TransDot accumulates into FP32 or FP16")
        if self.fused_quant and not self.use_kernel:
            raise ValueError("fused_quant is a kernel-path feature; set "
                             "use_kernel=True")
        if self.packed and not self.use_kernel:
            raise ValueError("packed operand movement is a kernel-path "
                             "feature; set use_kernel=True")
        if self.packed and not (get_format(self.fmt_weights).bits == 4
                                or get_format(self.fmt_acts).bits == 4):
            raise ValueError("packed storage needs a 4-bit operand format")
        if self.kv_packed and get_format(self.fmt_kv).bits != 4:
            raise ValueError("kv_packed needs a 4-bit fmt_kv")

    @property
    def enabled(self) -> bool:
        return not (self.fmt_weights == "fp32" and self.fmt_acts == "fp32")

    @property
    def attn_enabled(self) -> bool:
        """True when attention runs the DPA path (quantized operands
        and/or a quantized KV cache)."""
        return not (self.fmt_attn == "fp32" and self.fmt_kv == "fp32")

    @property
    def kv_quantized(self) -> bool:
        return self.fmt_kv != "fp32"

    @property
    def dpa_terms(self) -> int:
        """N = products per accumulation issue (min across operand sides)."""
        return min(DPA_TERMS[get_format(self.fmt_weights).name],
                   DPA_TERMS[get_format(self.fmt_acts).name])

    def replace(self, **kw) -> "TransPrecisionPolicy":
        return dataclasses.replace(self, **kw)


# Presets: the paper's four headline modes + bf16 (TPU-native comparison)
POLICIES = {
    "fp32": TransPrecisionPolicy(),
    "bf16_dpa": TransPrecisionPolicy("bf16", "bf16"),
    "fp16_dpa": TransPrecisionPolicy("fp16", "fp16"),
    "fp8_dpa": TransPrecisionPolicy("fp8_e4m3", "fp8_e4m3"),
    "fp4_dpa": TransPrecisionPolicy("fp4_e2m1", "fp8_e4m3"),
    # weight-only variants (serving: weights ride the narrow wires)
    "w8a16": TransPrecisionPolicy("fp8_e4m3", "fp16"),
    "w4a8": TransPrecisionPolicy("fp4_e2m1", "fp8_e4m3"),
    # kernel-path serving modes: packed fp4 operand bytes and/or in-kernel
    # activation quantization (the fused quantize->pack->DPA pipeline)
    "fp8_dpa_fused": TransPrecisionPolicy("fp8_e4m3", "fp8_e4m3",
                                          use_kernel=True, fused_quant=True),
    "fp4_dpa_packed": TransPrecisionPolicy("fp4_e2m1", "fp4_e2m1",
                                           use_kernel=True, packed=True),
    "fp4_dpa_fused": TransPrecisionPolicy("fp4_e2m1", "fp4_e2m1",
                                          use_kernel=True, packed=True,
                                          fused_quant=True),
    "w4a8_packed": TransPrecisionPolicy("fp4_e2m1", "fp8_e4m3",
                                        use_kernel=True, packed=True,
                                        fused_quant=True),
    # DPA-quantized attention: QK^T / PV accumulate f32 over narrow
    # operands; fmt_kv holds the cache at format width (decode bandwidth)
    "attn_fp16_dpa": TransPrecisionPolicy(fmt_attn="fp16", fmt_kv="fp16"),
    "attn_fp8_dpa": TransPrecisionPolicy(fmt_attn="fp8_e4m3",
                                         fmt_kv="fp8_e4m3"),
    "attn_fp4_packed": TransPrecisionPolicy(fmt_attn="fp4_e2m1",
                                            fmt_kv="fp4_e2m1",
                                            kv_packed=True),
    # trans-precision serving sweet spot: fp8 attention arithmetic over a
    # packed-fp4 cache (the w4a8 idea applied to attention operands)
    "kv4_attn8_packed": TransPrecisionPolicy(fmt_attn="fp8_e4m3",
                                             fmt_kv="fp4_e2m1",
                                             kv_packed=True),
    # cache-only compression: attention arithmetic stays f32
    "kv8_attn_f32": TransPrecisionPolicy(fmt_kv="fp8_e4m3"),
    "kv16_attn_f32": TransPrecisionPolicy(fmt_kv="fp16"),
    # self-speculative draft mode: every matmul side (linears AND both
    # attention matmuls) runs fp4-grid operands — the paper's 8-term DPA
    # route end to end — over the same packed-fp4 cache the fp4-KV
    # serving presets keep, so the draft and verify policies share one
    # page pool (serving.spec_decode pairs this with kv4_attn8_packed)
    "w4a4_kv4_attn4": TransPrecisionPolicy("fp4_e2m1", "fp4_e2m1",
                                           fmt_attn="fp4_e2m1",
                                           fmt_kv="fp4_e2m1",
                                           kv_packed=True),
    # fp16-class draft rung over the packed-fp4 cache: fp16 operands on
    # the linears and both attention matmuls (2-term DPA, the most
    # precise Table-I mode above fp32) while KV storage stays fp4 packed
    # — the top of the adaptive draft ladder for fp4-cache serving
    # presets (`repro.runtime.controller.DEFAULT_LADDERS`)
    "w16a16_kv4_attn16": TransPrecisionPolicy("fp16", "fp16",
                                              fmt_attn="fp16",
                                              fmt_kv="fp4_e2m1",
                                              kv_packed=True),
    # full serving path: packed-fp4 weights + fused fp8 activations on the
    # linears, fp8 DPA attention, packed-fp4 KV cache
    "w4a8_kv4_attn8": TransPrecisionPolicy("fp4_e2m1", "fp8_e4m3",
                                           use_kernel=True, packed=True,
                                           fused_quant=True,
                                           fmt_attn="fp8_e4m3",
                                           fmt_kv="fp4_e2m1",
                                           kv_packed=True),
    # all-fp8 serving: fused fp8 kernel linears, fp8 DPA attention, fp8
    # cache — the 4x-vs-f32 operand-byte point on the Table-I ladder (the
    # packed-fp4 preset above is the 8x point)
    "w8a8_kv8_attn8": TransPrecisionPolicy("fp8_e4m3", "fp8_e4m3",
                                           use_kernel=True,
                                           fused_quant=True,
                                           fmt_attn="fp8_e4m3",
                                           fmt_kv="fp8_e4m3"),
}


def get_policy(name) -> TransPrecisionPolicy:
    if isinstance(name, TransPrecisionPolicy):
        return name
    return POLICIES[name]
