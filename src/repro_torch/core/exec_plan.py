"""Execution-plan layer — one dispatch seam for every DPA-shaped op
(port of `repro.core.exec_plan`).

A declarative routing table keyed on (op, policy mode bits, shape
predicates, backend).  `repro_torch.kernels.registry` registers every
route with a named-boolean predicate; `resolve(op, policy, **ctx)`
returns the highest-priority eligible route, `describe` states which
route serves a call and why.  Resolution is deterministic: candidates
are ordered by (priority desc, name) and the first fully eligible entry
wins.

Measured tuning (`repro_torch.runtime.tuner`): when a measurement DB is
active, `resolve` consults it after the priority scan, whose choice stays
the untuned prior.  A tuned selection stays inside the prior's reference
family and, where the prior is a CUDA route, among CUDA routes; it may
carry launch-plan `knobs` for the route's kernel.  No environment
variable opens or closes the consult: the DB is made active by an
explicit `use_tuned_db(path)` (the front end's `--tuned-db`, or the
caller of `launch.engine.Engine`) and closed by `use_tuned_db(None)`.
`describe()` states whether a resolution was ``tuned`` or ``prior``.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Optional, Union

from .policy import get_policy


class PlanError(ValueError):
    """No registered route can serve (op, policy, shapes)."""


@dataclasses.dataclass(frozen=True)
class PlanEntry:
    """One row of the routing table.

    predicate(policy, ctx) -> {bit: bool}; the route is eligible iff all
    bits hold.  `run` has a per-op uniform signature.  `reference` names
    the route this entry is held against at `tol` max-abs error: a number,
    or tol(policy, ctx) where the bound depends on the policy's formats.
    `tests` names the `tests/test_torch_*.py` tests that exercise the
    route (`launch/plan_table.py --check` fails on a route naming none).
    `knobs` names the launch-plan keywords `run` takes (the tuner sweeps
    them); `plan(policy, ctx, **knobs)` returns the launch plan they give
    at ctx, or raises `ValueError` where the kernel refuses them.  The
    tuned-provenance fields are set only on entries the tuner mints."""
    op: str
    name: str
    backend: str                       # "cuda" | "torch"
    run: Callable
    predicate: Callable
    priority: int = 0
    reference: Optional[str] = None
    tol: Union[float, Callable] = 0.0
    bytes_moved: Optional[Callable] = None
    note: str = ""
    tests: tuple = ()
    knobs: tuple = ()                  # launch-plan keywords of `run`
    plan: Optional[Callable] = None    # (policy, ctx, **knobs) -> plan
    tuned: bool = False
    tuned_class: str = ""              # shape class the record keyed on
    tuned_knobs: tuple = ()            # sorted ((knob, value), ...)

    def eligible(self, policy, ctx) -> bool:
        return all(self.predicate(policy, ctx).values())

    def describe(self, policy, ctx) -> dict:
        bm = self.bytes_moved(policy, ctx) if self.bytes_moved else None
        d = {"op": self.op, "route": self.name, "backend": self.backend,
             "predicates": self.predicate(policy, ctx),
             "bytes_moved": bm, "reference": self.reference,
             "tol": self.tol(policy, ctx) if callable(self.tol)
             else self.tol,
             "selection": "tuned" if self.tuned else "prior"}
        if self.tuned:
            d["shape_class"] = self.tuned_class
            d["tuned_knobs"] = dict(self.tuned_knobs)
        return d


_TABLE: dict[str, list[PlanEntry]] = {}
_BACKENDS_LOADED = False


def register(op: str, name: str, *, backend: str, run: Callable,
             predicate: Callable = None, priority: int = 0,
             reference: Optional[str] = None,
             tol: Union[float, Callable] = 0.0,
             bytes_moved: Optional[Callable] = None,
             note: str = "", tests: tuple = (), knobs: tuple = (),
             plan: Optional[Callable] = None) -> PlanEntry:
    """Add one route to the table; duplicate (op, name) is an error."""
    rows = _TABLE.setdefault(op, [])
    if any(e.name == name for e in rows):
        raise ValueError(f"route {op}/{name} registered twice")
    entry = PlanEntry(op=op, name=name, backend=backend, run=run,
                      predicate=predicate or (lambda policy, ctx: {}),
                      priority=priority, reference=reference, tol=tol,
                      bytes_moved=bytes_moved, note=note,
                      tests=tuple(tests), knobs=tuple(knobs), plan=plan)
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


_TUNED_DB: Optional[str] = None


def use_tuned_db(path: Optional[str]) -> Optional[str]:
    """Make the measurement DB at `path` the one `resolve` consults (None:
    no DB, the priority scan alone).  -> the DB active before.  Plans are
    chosen where a step resolves them: a CUDA graph captured before the
    call keeps the launches it captured."""
    global _TUNED_DB
    before, _TUNED_DB = _TUNED_DB, (str(path) if path else None)
    return before


def tuned_db() -> Optional[str]:
    """The active measurement DB's path, or None."""
    return _TUNED_DB


def resolve(op: str, policy=None, **ctx) -> PlanEntry:
    """-> the highest-priority eligible route for (op, policy, ctx), or,
    with a DB active, the tuner's measured choice within its family;
    raises `PlanError` with every candidate's predicate bits."""
    policy = get_policy(policy if policy is not None else "fp32")
    for entry in candidates(op):
        if entry.eligible(policy, ctx):
            if _TUNED_DB is None:
                return entry
            tuned = _tuned_choice(op, policy, ctx, entry)
            return tuned if tuned is not None else entry
    tried = {e.name: e.predicate(policy, ctx) for e in _TABLE[op]}
    raise PlanError(f"no {op} route serves policy={policy} ctx={ctx}; "
                    f"predicates: {tried}")


def _tuned_choice(op: str, policy, ctx: dict, static: PlanEntry):
    """The active DB's choice for (op, policy, ctx), or None for the prior:
    every failure of the consult degrades to the priority scan's route."""
    from repro_torch.runtime import tuner
    try:
        return tuner.tuned_entry(_TUNED_DB, op, policy, ctx, static)
    except Exception as exc:  # noqa: BLE001 — a bad DB must not break resolve
        tuner.warn_once(f"tuned lookup failed for {op}: {exc!r}; using "
                        "the priority order")
        return None


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
