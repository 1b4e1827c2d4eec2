"""The kernel wrappers' launch counters and their work, in one list.

Each wrapper adds one to its `.launches` where it launches its kernel,
and the wrappers with routes or a pre-pass one to `.<route>_launches`
too (`dpa_matmul_fused.splitk_launches`, `.tiled_launches`, the flash
wrappers' `.prepass_launches`; paged decode by attention format,
`.fp8_e4m3_launches`, `.fp4_e2m1_launches`, `.fp16_launches`; and the
launches a speculative verify pass made, paged decode's verify folds and
the fused matmuls' calls, `.verify_launches`).  Beside each launch
counter, `kernels.census` keeps the work of the launches it counts:
`.bytes`, `.ops` and `.bound_s` (`.<route>_bytes`, ...).  A snapshot
names the launches "wrapper" and "wrapper.route", and their work
"wrapper:bytes", "wrapper.route:bound_s", ... (`launches` keeps the
launch counters alone).

A speculative verify pass that runs its products one query row at a
time (`kernels.registry`, `per_row`) launches each row's call: each
counts as one launch with its own rows' work, so a verify pass at 160
rows adds two split-K launches a linear (calls of 96 and 64 rows), as
the profiler sees them.

A replayed CUDA graph runs no Python, so no wrapper counts its launches
there: `launch.graphs.StepGraph` takes the snapshots' difference over its
capture (`diff`) and adds it once per replay (`add`), work included.
"""
from __future__ import annotations

from . import dpa_grouped_matmul as GM
from . import dpa_matmul as DM
from . import flash_attention as FA
from . import paged_decode as PD
from . import quantize as QZ
from .census import WORK

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
    """-> [(snapshot key, wrapper, attribute)] for every counter: each
    launch counter, then its work where the wrapper keeps it."""
    out = []
    for name, fn in wrappers.items():
        attrs = vars(fn)
        routes = sorted(a[:-len("_launches")] for a in attrs
                        if a.endswith("_launches"))
        for key, prefix in [(name, "")] + [(f"{name}.{r}", f"{r}_")
                                            for r in routes]:
            out.append((key, fn, prefix + "launches"))
            out.extend((f"{key}:{w}", fn, prefix + w) for w in WORK
                       if prefix + w in attrs)
    return out


def snapshot(wrappers=None) -> dict:
    """Every counter's value, keyed "wrapper" or "wrapper.route" (the
    launches) and "<that>:bytes", ":ops", ":bound_s" (their work)."""
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


def launches(snap: dict) -> dict:
    """The launch counters of a snapshot (or of a `diff`)."""
    return {k: v for k, v in snap.items() if ":" not in k}

