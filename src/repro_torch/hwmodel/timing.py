"""Area-delay trade-off curves — Fig. 6a (shifters) and Fig. 6b (multipliers).

Synthesis area(delay) is modeled as a paper-anchored curve per design:
flat at its relaxed-timing asymptote, rising as the delay target
approaches the design's minimum achievable delay (the synthesizer trades
area for speed).  All anchor constants come from §III-A/§III-B.
"""
from __future__ import annotations

from .area import barrel_shifter_muxes


def _curve_factor(delay, d_min, *, steep=2.0):
    """Relative synthesis area factor >= 1: 1.0 at relaxed delay, rising
    as the target approaches the design's minimum achievable delay.
    Unachievable targets (delay < d_min) sit on the max-effort wall."""
    d_eff = max(delay, d_min * 1.02)
    k = (d_min * 1.02 * 1.6) / d_eff
    return 1.0 + max(0.0, k - 1.0) ** steep


def _synth_curve(delay, a_relaxed, d_min, *, steep=2.0):
    return a_relaxed * _curve_factor(delay, d_min, steep=steep)


# ---------------------------------------------------------------------------
# Fig. 6a: 100-bit shifters.  Anchors: reconfigurable converges to baseline
# above 400 ps; multi-lane stays 35.8%..67.2% larger; tightening below
# 400 ps drives the reconfigurable design toward the multi-lane area.
# ---------------------------------------------------------------------------

SHIFTER_WIDTH = 100
_S_BASE = barrel_shifter_muxes(128)        # synthesized-cell proxy units
_S_DMIN_PS = 180.0


def shifter_area(delay_ps: float, design: str) -> float:
    base = _synth_curve(delay_ps, _S_BASE, _S_DMIN_PS)
    if design == "single":
        return base
    if design == "multilane":
        lo, hi = 0.358, 0.672
        t = min(1.0, max(0.0, (500.0 - delay_ps) / (500.0 - _S_DMIN_PS)))
        return base * (1.0 + lo + (hi - lo) * t)
    if design == "reconfig":
        # converges to baseline >=400ps; approaches multi-lane when tight
        if delay_ps >= 400.0:
            return base
        t = (400.0 - delay_ps) / (400.0 - _S_DMIN_PS)
        target = shifter_area(delay_ps, "multilane")
        return base + (target - base) * min(1.0, t) ** 2
    raise ValueError(design)


# ---------------------------------------------------------------------------
# Fig. 6b: multipliers.  Anchors (§III-B): combinational TransDot min
# delay 1.38 ns vs separated 1.50 ns; -15.4% area at 1.6 ns.  Pipelined:
# 0.86 vs 0.88 ns; -15.8% area at 1.0 ns.
# ---------------------------------------------------------------------------

_M_BASE = 1000.0


def multiplier_area(delay_ns: float, design: str, *, pipelined: bool) -> float:
    if design == "transdot":
        d_min, a_rel = (0.86, _M_BASE * 1.06) if pipelined else (1.38, _M_BASE)
        return _synth_curve(delay_ns, a_rel, d_min)
    if design == "separated":
        if pipelined:
            d_min, d_anchor, saving = 0.88, 1.0, 0.158
        else:
            d_min, d_anchor, saving = 1.50, 1.6, 0.154
        # calibrate the relaxed asymptote so the paper's saving holds
        # exactly at its anchor delay
        target = multiplier_area(d_anchor, "transdot",
                                 pipelined=pipelined) / (1 - saving)
        a_rel = target / _curve_factor(d_anchor, d_min)
        return _synth_curve(delay_ns, a_rel, d_min)
    raise ValueError(design)


def multiplier_min_delay(design: str, *, pipelined: bool) -> float:
    return {("transdot", False): 1.38, ("separated", False): 1.50,
            ("transdot", True): 0.86, ("separated", True): 0.88}[
        (design, pipelined)]
