"""Execution-plan layer — one dispatch seam for every DPA-shaped op
(port of `repro.core.exec_plan`).

A declarative routing table keyed on (op, policy mode bits, shape
predicates, backend).  `repro_torch.kernels.registry` registers every
route with a named-boolean predicate; `resolve(op, policy, **ctx)`
returns the highest-priority eligible route, `describe` states which
route serves a call and why.  Resolution is deterministic: candidates
are ordered by (priority desc, name) and the first fully eligible entry
wins.

The reference's measured-tuning consult (`REPRO_TUNED_DB`) belongs to
the tuner's slice of the port and is not here: resolution is exactly the
priority scan.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional

from .policy import get_policy


class PlanError(ValueError):
    """No registered route can serve (op, policy, shapes)."""


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One row of the routing table.

    predicate(policy, ctx) -> {bit: bool}; the route is eligible iff all
    bits hold.  `run` has a per-op uniform signature.  `reference` names
    the route this entry is held against at `tol` max-abs error."""
    op: str
    name: str
    backend: str                       # "cuda" | "torch"
    run: Callable
    predicate: Callable
    priority: int = 0
    reference: Optional[str] = None
    tol: float = 0.0
    bytes_moved: Optional[Callable] = None
    note: str = ""

    def eligible(self, policy, ctx) -> bool:
        return all(self.predicate(policy, ctx).values())

    def describe(self, policy, ctx) -> dict:
        bm = self.bytes_moved(policy, ctx) if self.bytes_moved else None
        return {"op": self.op, "route": self.name, "backend": self.backend,
                "predicates": self.predicate(policy, ctx),
                "bytes_moved": bm, "reference": self.reference,
                "tol": self.tol}


_TABLE: dict[str, list[PlanEntry]] = {}
_BACKENDS_LOADED = False


def register(op: str, name: str, *, backend: str, run: Callable,
             predicate: Callable = None, priority: int = 0,
             reference: Optional[str] = None, tol: float = 0.0,
             bytes_moved: Optional[Callable] = None,
             note: str = "") -> PlanEntry:
    """Add one route to the table; duplicate (op, name) is an error."""
    rows = _TABLE.setdefault(op, [])
    if any(e.name == name for e in rows):
        raise ValueError(f"route {op}/{name} registered twice")
    entry = PlanEntry(op=op, name=name, backend=backend, run=run,
                      predicate=predicate or (lambda policy, ctx: {}),
                      priority=priority, reference=reference, tol=tol,
                      bytes_moved=bytes_moved, note=note)
    rows.append(entry)
    rows.sort(key=lambda e: (-e.priority, e.name))
    return entry


def _ensure_backends() -> None:
    """Import the routing table once, on first resolution."""
    global _BACKENDS_LOADED
    if not _BACKENDS_LOADED:
        importlib.import_module("repro_torch.kernels.registry")
        _BACKENDS_LOADED = True


def candidates(op: str) -> list:
    """All registered routes for `op`, in resolution order."""
    _ensure_backends()
    if op not in _TABLE:
        raise PlanError(f"unknown op {op!r}; registered: {sorted(_TABLE)}")
    return list(_TABLE[op])


def ops() -> list:
    _ensure_backends()
    return sorted(_TABLE)


def route(op: str, name: str) -> PlanEntry:
    """Fetch one route by name."""
    for e in candidates(op):
        if e.name == name:
            return e
    raise PlanError(f"no route {op}/{name}")


def resolve(op: str, policy=None, **ctx) -> PlanEntry:
    """-> the highest-priority eligible route for (op, policy, ctx);
    raises `PlanError` with every candidate's predicate bits."""
    policy = get_policy(policy if policy is not None else "fp32")
    for entry in candidates(op):
        if entry.eligible(policy, ctx):
            return entry
    tried = {e.name: e.predicate(policy, ctx) for e in _TABLE[op]}
    raise PlanError(f"no {op} route serves policy={policy} ctx={ctx}; "
                    f"predicates: {tried}")


def describe(op: str, policy=None, **ctx) -> dict:
    """The selected route plus every candidate's predicate bits."""
    policy = get_policy(policy if policy is not None else "fp32")
    entry = resolve(op, policy, **ctx)
    return dict(entry.describe(policy, ctx),
                candidates={e.name: e.predicate(policy, ctx)
                            for e in candidates(op)})


def reference_entry(entry: PlanEntry) -> Optional[PlanEntry]:
    if entry.reference is None:
        return None
    return route(entry.op, entry.reference)
