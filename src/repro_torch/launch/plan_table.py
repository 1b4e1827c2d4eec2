"""Print the port's routing table and check it (port of the checks of
`tools/plan_table.py`).

  python -m repro_torch.launch.plan_table [--check] [--db PATH ...]

Renders every `core.exec_plan` route (op, route, backend, priority,
reference and its tolerance, knobs, tests) and checks:

  - every route names at least one test, and each named
    `tests/test_torch_*.py` file exists (a `file::name` entry names a test
    function defined in it);
  - every launch-plan knob a route's `run` takes is declared
    (`PlanEntry.knobs`), every declared knob has a grid in the tuner's
    space (`runtime.tuner.KNOB_GRID`) and a route with knobs has a `plan`;
  - every record of each DB named with `--db` names a live route and
    shape class, carries only the route's declared knobs, and hashes to
    its own key;
  - every default draft ladder (`runtime.controller.DEFAULT_LADDERS`) is
    servable: for every KV-quantized serving preset, each rung shares the
    serving cache layout (`validate_policy_pair`) and resolves a
    ``paged_decode`` route.

`--check` prints the verdict alone; exit 1 on any problem.
"""
from __future__ import annotations

import argparse
import glob
import inspect
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _test_exists(ref: str) -> bool:
    """'tests/test_torch_x.py' or '...::test_name' resolves on disk."""
    path, _, name = ref.partition("::")
    if not re.fullmatch(r"tests/test_torch_\w+\.py", path):
        return False
    full = os.path.join(ROOT, path)
    if not os.path.isfile(full):
        return False
    if not name:
        return True
    with open(full, encoding="utf-8") as f:
        text = f.read()
    return re.search(rf"^def {re.escape(name)}\b", text, re.M) is not None


def knob_errors(entry) -> list:
    """The tuner's contract for one route: every knob-named keyword its
    `run` takes is declared, every declared knob has a grid and is taken,
    and a route with knobs has a `plan` to check them."""
    from repro_torch.runtime import tuner
    errs = []
    try:
        params = inspect.signature(entry.run).parameters
    except (TypeError, ValueError):
        params = {}
    exposed = {n for n, p in params.items()
               if n in tuner.KNOB_GRID and p.kind in (
                   inspect.Parameter.KEYWORD_ONLY,
                   inspect.Parameter.POSITIONAL_OR_KEYWORD)}
    where = f"{entry.op}/{entry.name}"
    for knob in sorted(exposed - set(entry.knobs)):
        errs.append(f"{where}: run() takes launch-plan knob {knob!r} but "
                    "the route does not declare it (knobs=...)")
    for knob in entry.knobs:
        if knob not in tuner.KNOB_GRID:
            errs.append(f"{where}: declared knob {knob!r} has no grid in "
                        "tuner.KNOB_GRID: the sweep can never measure it")
        elif knob not in exposed:
            errs.append(f"{where}: declares knob {knob!r} that run() does "
                        "not accept")
    if entry.knobs and entry.plan is None:
        errs.append(f"{where}: declares knobs but no plan() to check them")
    return errs


def db_errors(path: str) -> list:
    """Every record of the DB at `path`: a live route and shape class,
    only declared knobs, and its own content hash as its key."""
    from repro_torch.core import exec_plan
    from repro_torch.runtime import tuner
    rel = os.path.relpath(path, ROOT)
    try:
        with open(path) as f:
            raw = json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        return [f"{rel}: unreadable ({exc})"]
    errs = []
    for h, rec in (raw.get("records") or {}).items():
        where = f"{rel}[{h}]"
        if not isinstance(rec, dict) or "op" not in rec or "route" not in rec:
            errs.append(f"{where}: malformed record")
            continue
        knobs = set(rec.get("knobs") or {})
        if rec["op"] == tuner.ENGINE_OP:
            extra = knobs - set(tuner.ENGINE_KNOB_GRID)
            if extra:
                errs.append(f"{where}: unknown engine knob(s) {sorted(extra)}")
        else:
            try:
                entry = exec_plan.route(rec["op"], rec["route"])
            except exec_plan.PlanError:
                errs.append(f"{where}: names nonexistent route "
                            f"{rec['op']}/{rec['route']}")
                continue
            if rec.get("shape_class") not in {
                    sc.name for sc in tuner.SHAPE_CLASSES
                    if sc.op == rec["op"]}:
                errs.append(f"{where}: unknown shape class "
                            f"{rec.get('shape_class')!r} for {rec['op']}")
            extra = knobs - set(entry.knobs)
            if extra:
                errs.append(f"{where}: knob(s) {sorted(extra)} not declared "
                            f"by {rec['op']}/{rec['route']}")
        try:
            if tuner.config_hash(rec) != h:
                errs.append(f"{where}: key does not match the record's "
                            "content hash")
        except KeyError as exc:
            errs.append(f"{where}: missing hash field {exc}")
    return errs


def ladder_errors() -> list:
    """Every KV-quantized serving preset maps to a default ladder whose
    every rung shares the serving cache layout and resolves a
    ``paged_decode`` route at an engine-shaped ctx."""
    from repro_torch.core import exec_plan
    from repro_torch.core.policy import POLICIES
    from repro_torch.runtime import controller
    from repro_torch.serving.spec_decode import validate_policy_pair
    ctx = dict(batch=4, page_size=8, max_pages=4, kv_heads=2, hd=16,
               n_pages=32, n_devices=1)
    errs = []
    for serve_name, serve_pol in sorted(POLICIES.items()):
        if not serve_pol.kv_quantized:
            continue
        try:
            ladder = controller.default_ladder(serve_name)
        except ValueError as exc:
            errs.append(f"ladder[{serve_name}]: no default ladder ({exc})")
            continue
        for rung in ladder:
            try:
                rpol = validate_policy_pair(rung, serve_pol)
            except ValueError as exc:
                errs.append(f"ladder[{serve_name}]/{rung}: cache layout "
                            f"mismatch ({exc})")
                continue
            try:
                exec_plan.resolve("paged_decode", rpol, **ctx)
            except exec_plan.PlanError as exc:
                errs.append(f"ladder[{serve_name}]/{rung}: no paged_decode "
                            f"route ({exc})")
    return errs


def collect(dbs=()):
    """-> (every route, every problem found)."""
    from repro_torch.core import exec_plan
    rows, errors = [], []
    for op in exec_plan.ops():
        for e in exec_plan.candidates(op):
            rows.append(e)
            if not e.tests:
                errors.append(f"{op}/{e.name}: no test registered")
            for t in e.tests:
                if not _test_exists(t):
                    errors.append(f"{op}/{e.name}: test {t!r} not found")
            errors.extend(knob_errors(e))
    for path in dbs:
        errors.extend(db_errors(path))
    errors.extend(ladder_errors())
    return rows, errors


def render(rows) -> str:
    head = (f"{'op':<15} {'route':<22} {'backend':<7} {'prio':>4} "
            f"{'reference (tol)':<26} {'knobs':<12} tests")
    lines = [head, "-" * len(head)]
    for e in rows:
        tol = "(per format)" if callable(e.tol) else f"({e.tol:g})"
        ref = f"{e.reference} {tol}" if e.reference else "- (is ref)"
        tests = ", ".join(t.split("/")[-1] for t in e.tests) or "NONE"
        lines.append(f"{e.op:<15} {e.name:<22} {e.backend:<7} "
                     f"{e.priority:>4} {ref:<26} "
                     f"{','.join(e.knobs) or '-':<12} {tests}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="the verdict alone, no table")
    ap.add_argument("--db", nargs="*", default=[],
                    help="measurement DBs whose records to check (globs)")
    args = ap.parse_args(argv)
    dbs = sorted({p for pat in args.db for p in glob.glob(pat)})
    rows, errors = collect(dbs)
    if not args.check:
        print(render(rows))
        print()
    if errors:
        print(f"plan table check: {len(errors)} problem(s)")
        for err in errors:
            print(f"  FAIL {err}")
        return 1
    print(f"plan table check: {len(rows)} routes, every named test exists"
          + (f", {len(dbs)} DB(s) consistent" if dbs else ""))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
