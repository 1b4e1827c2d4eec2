"""Analytical hardware model reproducing the paper's evaluation
(Tables I/II, Figs. 3/6/7), the port's own copy of `repro.hwmodel`
(pure Python, which the port may not import).  The paper's claims are
synthesis numbers; this package encodes its formulas and anchors so the
tables can be regenerated and the tests assert the headline results
(2x/4x/8x DPA throughput, +37.3% area, 1.46x/2.92x area efficiency,
10.7%/13.8% shifter overhead, 78.5%/75% multi-lane cost)."""
from . import area, energy, throughput, timing  # noqa: F401
