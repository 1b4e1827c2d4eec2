"""The kernel wrappers' launch counters, in one list.

Each wrapper adds one to its `.launches` where it launches its kernel,
and the wrappers with routes or a pre-pass one to `.<route>_launches`
too (`dpa_matmul_fused.splitk_launches`, `.tiled_launches`, the flash
wrappers' `.prepass_launches`; paged decode by attention format,
`.fp8_e4m3_launches`, `.fp4_e2m1_launches`, `.fp16_launches`, and its
speculative verify folds, `.verify_launches`).  A snapshot names them
"wrapper" and "wrapper.route".

A replayed CUDA graph runs no Python, so no wrapper counts its launches
there: `launch.graphs.StepGraph` takes the snapshots' difference over its
capture (`diff`) and adds it once per replay (`add`).
"""
from __future__ import annotations

from . import dpa_grouped_matmul as GM
from . import dpa_matmul as DM
from . import flash_attention as FA
from . import paged_decode as PD
from . import quantize as QZ

WRAPPERS = {"dpa_matmul_fused": DM.dpa_matmul_fused,
            "paged_decode_attention": PD.paged_decode_attention,
            "dpa_matmul_prequant": DM.dpa_matmul_prequant,
            "dpa_grouped_matmul_fused": GM.dpa_grouped_matmul_fused,
            "dpa_grouped_matmul_prequant": GM.dpa_grouped_matmul_prequant,
            "dpa_flash_attention": FA.dpa_flash_attention,
            "flash_attention": FA.flash_attention,
            "quantize_rows": QZ.quantize_rows,
            "quantize_pack_rows": QZ.quantize_pack_rows,
            "dpa_act_quant": DM.dpa_act_quant}


def _counters(wrappers):
    """-> [(snapshot key, wrapper, attribute)] for every counter."""
    out = []
    for name, fn in wrappers.items():
        out.append((name, fn, "launches"))
        for attr in sorted(vars(fn)):
            if attr.endswith("_launches"):
                out.append((f"{name}.{attr[:-len('_launches')]}", fn, attr))
    return out


def snapshot(wrappers=None) -> dict:
    """Every counter's value, keyed "wrapper" or "wrapper.route"."""
    return {key: getattr(fn, attr)
            for key, fn, attr in _counters(wrappers or WRAPPERS)}


def zero(wrappers=None) -> None:
    for _, fn, attr in _counters(wrappers or WRAPPERS):
        setattr(fn, attr, 0)


def diff(after: dict, before: dict) -> dict:
    """The counters' change between two snapshots."""
    return {key: after[key] - before[key] for key in after}


def add(delta: dict, n: int = 1, wrappers=None) -> None:
    """Add `delta` n times to the counters (n < 0 takes it back)."""
    for key, fn, attr in _counters(wrappers or WRAPPERS):
        setattr(fn, attr, getattr(fn, attr) + n * delta.get(key, 0))
