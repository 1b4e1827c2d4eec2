"""Fill a measurement DB with the tuner's sweep (port of `tools/tune.py`;
`repro_torch.runtime.tuner`).

Measures every (op, policy, shape class, shape, route, knobs) config of
the tuner's space as an isolated cutout at the layer shapes of the named
model configurations, and keeps the results in a JSON DB keyed by
content hash: a rerun skips what is measured, and the space shards over
workers with no coordination:

    # on the card: the serving paths' shapes at full width
    python -m repro_torch.launch.tune --db build/tuned.json --smoke
    python -m repro_torch.launch.tune --db build/tuned.json --smoke --verify
    # on the CPU (reduced configs, plain versions)
    python -m repro_torch.launch.tune --db build/tuned_cpu.json --smoke \
        --device cpu
    # worker i of n, each its own file, then merged
    python -m repro_torch.launch.tune --db part1.json --shard 1/2
    python -m repro_torch.launch.tune --db tuned.json --merge part0.json \
        part1.json

A record is keyed on the torch and CUDA versions and the device it was
measured on, and is used only there.  Serve with it through `python -m
repro_torch.launch.serve ... --tuned-db PATH`, or `exec_plan.use_tuned_db`;
`exec_plan.describe()` then states "tuned" or "prior" per resolution.
No environment variable turns the consult on or off.
"""
from __future__ import annotations

import argparse
import json


def _parse_shard(text: str):
    try:
        i, n = (int(v) for v in text.split("/"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"shard must look like i/n, got {text!r}")
    if not (n >= 1 and 0 <= i < n):
        raise argparse.ArgumentTypeError(f"bad shard {text!r}")
    return i, n


def _space(args) -> dict:
    return dict(configs=tuple(args.config), device=args.device,
                reduced=args.reduced or None)


def verify(db_path: str, smoke: bool, **space) -> int:
    """0 where the (smoke) space is fully measured and the consult
    resolves every key to one object, deterministically; else 1."""
    from repro_torch.core import exec_plan
    from repro_torch.runtime import tuner

    missing = tuner.missing_configs(db_path, smoke=smoke, **space)
    if missing:
        print(f"tune --verify: {len(missing)} unmeasured config(s)")
        for cfg in missing[:10]:
            print(f"  MISSING {cfg['op']}/{cfg['route']} {cfg['shape_class']}"
                  f" {cfg['shape']} {cfg['knobs']}")
        return 1
    before = exec_plan.use_tuned_db(db_path)
    tuner.clear_caches()
    checked, seen = 0, set()
    try:
        for cfg in tuner.enumerate_space(smoke=smoke, **space):
            key = (cfg["op"], cfg["policy"], json.dumps(cfg["ctx"],
                                                        sort_keys=True))
            if cfg["op"] == tuner.ENGINE_OP or key in seen:
                continue
            seen.add(key)
            first = exec_plan.resolve(cfg["op"], cfg["policy"], **cfg["ctx"])
            if exec_plan.resolve(cfg["op"], cfg["policy"],
                                 **cfg["ctx"]) is not first:
                print(f"tune --verify: nondeterministic resolve for "
                      f"{cfg['op']}/{cfg['shape_class']} {cfg['shape']}")
                return 1
            d = exec_plan.describe(cfg["op"], cfg["policy"], **cfg["ctx"])
            print(f"  {cfg['op']:<14} {cfg['shape_class']:<13} "
                  f"{str(cfg['shape']):<22} {cfg['policy']:<15} -> "
                  f"{first.name} [{d['selection']}] "
                  f"knobs={d.get('tuned_knobs', {})}")
            checked += 1
    finally:
        exec_plan.use_tuned_db(before)
    print(f"  engine         {tuner.ENGINE_SHAPE_CLASS:<13} "
          f"{tuner.ENGINE_POLICY} -> best knobs "
          f"{tuner.best_engine_knobs(db_path)}")
    print(f"tune --verify: OK ({checked} keys, space fully measured)")
    return 0


def merge(dst: str, sources) -> int:
    from repro_torch.runtime import tuner
    db = tuner.load_db(dst)
    added = 0
    for src in sources:
        other = tuner.load_db(src)
        for h, rec in other["records"].items():
            if h not in db["records"]:
                db["records"][h] = rec
                added += 1
        if other["meta"]:
            db["meta"] = other["meta"]
    tuner.save_db(dst, db)
    print(f"merged {added} new record(s) into {dst} "
          f"({len(db['records'])} total)")
    return 0


def main(argv=None) -> int:
    from repro_torch.runtime import tuner
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--db", required=True, help="measurement DB path")
    p.add_argument("--smoke", action="store_true",
                   help="the smaller grids (a subset of the full space)")
    p.add_argument("--shard", type=_parse_shard, default=(0, 1),
                   metavar="i/n", help="measure shard i of n (by hash)")
    p.add_argument("--reps", type=int, default=None,
                   help="timed repetitions a cutout (default: 25 graph "
                        "replays on the card, 3 calls on the CPU)")
    p.add_argument("--ops", nargs="*", default=None,
                   help="restrict to these ops (default: all)")
    p.add_argument("--policies", nargs="*", default=None,
                   help="restrict to these policy presets")
    p.add_argument("--config", type=lambda t: t.split(","),
                   default=list(tuner.DEFAULT_CONFIGS),
                   help="comma-separated model configs whose layer shapes "
                        "the sweep measures (default: the serving paths', "
                        + ",".join(tuner.DEFAULT_CONFIGS) + ")")
    p.add_argument("--device", default="cuda",
                   help="where the cutouts run (the CPU measures the plain "
                        "versions, at reduced configs)")
    p.add_argument("--reduced", action="store_true",
                   help="reduced configs on the card too")
    p.add_argument("--verify", action="store_true",
                   help="no sweep: the space is fully measured and the "
                        "consult deterministic")
    p.add_argument("--merge", nargs="*", default=None, metavar="SRC",
                   help="no sweep: merge SRC DBs into --db")
    args = p.parse_args(argv)

    if args.merge is not None:
        return merge(args.db, args.merge)
    if args.verify:
        return verify(args.db, args.smoke, **_space(args))

    def progress(cfg, got):
        print(f"  {cfg['op']:<14} {cfg['shape_class']:<13} "
              f"{str(cfg['shape']):<22} {cfg['route']:<22} "
              f"{json.dumps(cfg['knobs']):<28} {got['us']:10.2f} us "
              f"(spread {got['spread']:.3f})")

    stats = tuner.run_sweep(args.db, smoke=args.smoke, shard=args.shard,
                            reps=args.reps, ops=args.ops,
                            policies=args.policies, progress=progress,
                            **_space(args))
    print(f"sweep: {stats['measured']} measured, {stats['skipped']} already "
          f"in the DB, {stats['other_shard']} on other shards (space: "
          f"{stats['total']})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
