"""Adaptive trans-precision control loop over the draft-precision ladder
(a copy of `repro.runtime.controller`, which the port may not import).

TransDot's thesis is one datapath reconfiguring across fp16/fp8/fp4 DPA
modes through a mode register; the serving analogue is reconfiguring at
runtime.  Speculative decoding (`repro_torch.serving.spec_decode`) emits
the feedback signal: per-round acceptance counts.  This module closes the
loop: a deterministic feedback controller walks a request's draft policy
up and down a precision ladder

    rung 0 (cheapest)  e.g. w4a4_kv4_attn4   8-term DPA, max throughput
    rung 1             e.g. w4a8_kv4_attn8   fp8-class fused pipeline
    rung 2 (precise)   e.g. w16a16_kv4_attn16  fp16-class operands

demoting toward fp4 (rung 0) while the acceptance EMA stays high and
promoting toward fp8/fp16 when it sags.  Every rung shares the serving
policy's KV-cache storage format (`validate_policy_pair`: one page pool
serves all rungs), so a switch re-routes the draft compute without
touching cache state, and rejection sampling keeps the emitted
distribution exactly the serving policy's whichever rung drafted.

Controller contract:

  pure      : ``step(cfg, state, accepted, drafted) -> (state, rung)``
              reads nothing but its arguments (no wall clock, no RNG, no
              globals), so any acceptance trace replays to the same rung
              sequence (`replay`).
  hysteresis: distinct demote/promote thresholds (``demote_above`` >
              ``promote_below``) leave a dead band where the EMA can
              wander without flapping the rung.
  dwell     : a rung switch is only considered after ``dwell`` rounds at
              the current rung.

The engine side (one draft step per rung, per-round batching of live
requests by rung, reservations sized against the ladder-wide max draft k)
lives in `repro_torch.launch.engine`.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Tuple

from repro_torch.core.policy import POLICIES, get_policy

# Default ladders keyed by the serving cache layout (fmt_kv, kv_packed):
# every rung stores KV exactly like the serving policy (the shared-pool
# precondition), ordered cheapest-first along the Table-I DPA modes —
# 8-term fp4, 4-term fp8, 2-term fp16 — with the most precise rung last.
DEFAULT_LADDERS = {
    ("fp4_e2m1", True): ("w4a4_kv4_attn4", "w4a8_kv4_attn8",
                         "w16a16_kv4_attn16"),
    ("fp8_e4m3", False): ("w8a8_kv8_attn8", "attn_fp8_dpa",
                          "kv8_attn_f32"),
    ("fp16", False): ("attn_fp16_dpa", "kv16_attn_f32"),
}


def default_ladder(serve_policy) -> Tuple[str, ...]:
    """The default draft-precision ladder for a serving policy preset.

    Keyed on the policy's cache layout: every rung shares the serving
    fmt_kv/kv_packed (so draft and verify write one page pool), and the
    names are POLICIES presets the engine can pre-build draft views
    for.  Raises for raw-f32-cache policies — the paged engine cannot
    serve them at all, adaptively or not."""
    pol = get_policy(serve_policy)
    if not pol.kv_quantized:
        raise ValueError(
            f"policy {serve_policy!r} keeps a raw f32 cache; the adaptive "
            "draft ladder rides the paged engine, which needs a fmt_kv "
            "preset (e.g. kv4_attn8_packed)")
    key = (pol.fmt_kv, pol.kv_packed)
    if key not in DEFAULT_LADDERS:
        raise ValueError(
            f"no default ladder for cache layout fmt_kv={pol.fmt_kv} "
            f"packed={pol.kv_packed}; known: {sorted(DEFAULT_LADDERS)}")
    return DEFAULT_LADDERS[key]


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Ladder + feedback-loop knobs.

    ladder: draft policy preset names, cheapest (fp4 / 8-term DPA)
    first, most precise last.  ks: per-rung draft length (empty = ``k``
    for every rung); reservations must be sized against ``max_k`` so a
    rung switch can never violate the engine's no-OOM invariant.
    demote_above / promote_below: acceptance-EMA thresholds — strictly
    ordered, the gap between them is the hysteresis dead band.  dwell:
    min rounds at a rung before a switch is considered.  ema_alpha:
    EMA weight of the newest round.  start: initial rung index (-1 =
    the most precise rung — demote as confidence builds)."""
    ladder: Tuple[str, ...]
    ks: Tuple[int, ...] = ()
    k: int = 4
    demote_above: float = 0.75
    promote_below: float = 0.45
    dwell: int = 2
    ema_alpha: float = 0.5
    start: int = -1

    def __post_init__(self):
        object.__setattr__(self, "ladder", tuple(self.ladder))
        object.__setattr__(self, "ks", tuple(self.ks))
        if not self.ladder:
            raise ValueError("ladder must name at least one rung")
        for name in self.ladder:
            if name not in POLICIES:
                raise ValueError(f"ladder rung {name!r} is not a policy "
                                 f"preset")
        if self.ks and len(self.ks) != len(self.ladder):
            raise ValueError(f"ks has {len(self.ks)} entries for a "
                             f"{len(self.ladder)}-rung ladder")
        if any(k < 1 for k in self.rung_ks):
            raise ValueError("every rung draft length must be >= 1")
        if not 0.0 <= self.promote_below < self.demote_above <= 1.0:
            raise ValueError(
                "need 0 <= promote_below < demote_above <= 1 (the gap is "
                f"the hysteresis band); got promote_below="
                f"{self.promote_below}, demote_above={self.demote_above}")
        if self.dwell < 1:
            raise ValueError("dwell must be >= 1 round")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError("ema_alpha must be in (0, 1]")
        if not -1 <= self.start < len(self.ladder):
            raise ValueError(f"start rung {self.start} outside the "
                             f"{len(self.ladder)}-rung ladder")

    @property
    def rung_ks(self) -> Tuple[int, ...]:
        return self.ks if self.ks else (self.k,) * len(self.ladder)

    @property
    def max_k(self) -> int:
        """Ladder-wide max draft length — what page reservations price."""
        return max(self.rung_ks)

    @property
    def start_rung(self) -> int:
        return len(self.ladder) - 1 if self.start == -1 else self.start


@dataclasses.dataclass(frozen=True)
class ControllerState:
    """Per-request controller state — a value, not an object: replaying
    the same observations from the same state yields the same states.

    ema < 0 means "no observation yet" (the first round's rate seeds the
    EMA directly); ``rounds`` counts rounds at the *current* rung (the
    dwell clock); ``switches`` counts rung changes over the request."""
    rung: int
    ema: float = -1.0
    rounds: int = 0
    switches: int = 0


def init_state(cfg: ControllerConfig) -> ControllerState:
    return ControllerState(rung=cfg.start_rung)


def step(cfg: ControllerConfig, state: ControllerState,
         accepted: int, drafted: int) -> Tuple[ControllerState, int]:
    """One feedback update: fold a round's acceptance count into the
    EMA, then (after the dwell) demote toward fp4 on a high EMA or
    promote toward precision on a low one.

    Pure and deterministic: ``(state, observation) -> (state, rung)``
    with no wall-clock or RNG inputs — the engine replays through here,
    and so can a unit test."""
    if drafted < 1:
        raise ValueError("a round drafts at least one token")
    rate = accepted / drafted
    ema = (rate if state.ema < 0.0
           else cfg.ema_alpha * rate + (1.0 - cfg.ema_alpha) * state.ema)
    rung, rounds, switches = state.rung, state.rounds + 1, state.switches
    if rounds >= cfg.dwell:
        if ema >= cfg.demote_above and rung > 0:
            rung, rounds, switches = rung - 1, 0, switches + 1
        elif ema <= cfg.promote_below and rung < len(cfg.ladder) - 1:
            rung, rounds, switches = rung + 1, 0, switches + 1
    return ControllerState(rung=rung, ema=ema, rounds=rounds,
                           switches=switches), rung


def replay(cfg: ControllerConfig,
           observations: Iterable[Tuple[int, int]]) -> List[int]:
    """Fold a trace of (accepted, drafted) observations through a fresh
    controller; returns the rung each round *ends* on.  Determinism in
    one line: ``replay(cfg, t) == replay(cfg, t)`` bit for bit."""
    state, rungs = init_state(cfg), []
    for accepted, drafted in observations:
        state, rung = step(cfg, state, accepted, drafted)
        rungs.append(rung)
    return rungs
