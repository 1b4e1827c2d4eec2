"""Measurement-driven tuner over the execution plan (port of
`repro.runtime.tuner`).

`core.exec_plan` resolves routes by static priority and the kernels
launch with plans picked by hand (`fused_plan`, `prequant_plan`,
`quantize_plan`, the flash blocks).  This module measures the
alternatives and lets the plan layer take the fastest:

  1. `enumerate_space()` builds the config space per (op, policy, shape
     class, shape): every route the consult could select (eligible at the
     shape, inside the static choice's reference family) x the route's
     launch-plan knobs (`PlanEntry.knobs`), each combination kept only
     where the route's `plan` accepts it and gives a launch of its own;
     the static plan (no knobs) is always there.  Plus the engine
     pseudo-op, page size and speculative k swept as one whole-engine
     cutout.
  2. `run_sweep()` measures each config as an isolated cutout (inputs
     from a `torch.Generator`, weights prepared by `prepare_linear` /
     `prepare_grouped_linear`) into a JSON DB keyed by `config_hash()`;
     measured configs are skipped, the space shards by content hash, and
     every save is atomic.
  3. `tuned_entry()` is `exec_plan.resolve`'s consult of the DB that
     `exec_plan.use_tuned_db(path)` made active: the fastest record for
     (op, policy key, class, shape) mints a `PlanEntry` that runs the
     measured route with the measured knobs.  Unmeasured keys, unknown,
     ineligible or out-of-family routes, unknown or refused knobs and
     corrupt DBs all fall back to the static prior, with a warning.

Departures from the reference, each forced by the card:

- **The key.** `env_fingerprint()` is {"torch", "cuda", "device": the
  card's name or "cpu"}, in place of `backend` and `jax_version` in
  `HASH_FIELDS`.  Only records of the exact environment are selected;
  records of another torch, CUDA or card are ignored with one warning
  (a DB measured elsewhere goes stale, as the reference's shipped one
  did).  The reference prefers exact records and then takes any.
- **The shape is in the key.**  A matmul record carries the weight shape
  [E, K, N] it ran at, a flash record [hd, Sq, Skv], a quantizer record
  [M, K], a paged record its cache geometry; the consult selects only a
  record whose shape equals the live ctx's.  The reference's
  representative shapes (m 8, k 128, n 128) say nothing on the card, and
  a split is valid only for the K it divides.
- **The split-K knobs are keyed without M.**  `splitk_cols` takes (E, K,
  N) alone so that no row's bits depend on M; a tuned (bn, split) holds
  the same way: the fused routes' knobs are measured in the decode class
  and selected from it at every M (`KNOB_CLASS`), so a decode step (M 4)
  and a verify pass (M 20) take the same split.
- **Never a plain route over a kernel.**  Where the priority scan picks
  a `cuda` route, only `cuda` routes of its family are selected; a
  record naming a `torch` route gets the out-of-family warning.  On the
  card tuning is therefore knob choice; where the scan picks a `torch`
  route the reference's reordering stays.
- **No environment variable** opens or closes the consult
  (`REPRO_TUNED_DB`, `REPRO_TUNED=0` are not ported): the DB is active
  between `exec_plan.use_tuned_db(path)` and `use_tuned_db(None)`.
- **Memoized consult**, on (DB path and mtime, op, policy key, class,
  shape, static route): eager steps are host-bound and `resolve` runs at
  every linear call.
- **Measurement.**  On the card a cutout is timed with CUDA events over
  replays of a CUDA graph holding its calls (so host gaps do not count):
  the median over >= 25 replays, with `reps` and the spread
  ((max - min) / median).  Ops that stream weights are timed cold, as a
  decode step sees them: the graph's calls rotate over weight copies
  beyond the 50 MB L2.  On the CPU, `time.perf_counter` per call.
- **Shapes.**  The sweep measures the layer shapes of model
  configurations (`--config`; by default the serving paths', qwen3-4b
  and granite-moe-1b-a400m), reduced (`reduce_config`) on the CPU.
- **The engine pseudo-op's fixture.**  On the CPU the reference's:
  reduced qwen3-4b under `kv4_attn8_packed`, its synthetic workload and
  grid.  Reduced qwen3-4b has head dim 16, which the paged kernel does
  not take, so on the card it is qwen3-4b at full width with the
  serving phase's geometry (`CARD_ENGINE_GEOMETRY`), pool rows and
  per-request rows held constant across page sizes (the view, and with
  it `paged_plan`'s split and the bits, stay the same).  Its speculative
  points (spec_k 2 and 4) run on the card as on the CPU.

DB schema (`version` 1)::

    {"version": 1, "meta": {"torch", "cuda", "device"},
     "records": {<config_hash>: {"op", "policy", "policy_key",
                                 "shape_class", "shape", "route", "knobs",
                                 "torch", "cuda", "device", "ctx",
                                 "us", "reps", "spread"}}}

`python -m repro_torch.launch.tune` is the command line; `launch/serve.py
--tuned-db PATH` serves with a DB.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import os
import statistics
import time
import warnings
from typing import Callable, Optional

SCHEMA_VERSION = 1

# -- knob grids ---------------------------------------------------------------
# Every combination is kept only where the route's `plan` takes it at the
# shape and gives a launch other than the static plan's, which is always
# measured (no knobs): tuned-vs-static is >= 1.0x on what was swept.
KNOB_GRID = {
    "bn": (16, 32, 64),                       # output columns a block
    "split": (1, 2, 3, 4, 5, 6, 7, 8),        # K over a cluster
    "bq": (32, 64, 128),                      # flash q rows a block
    "bk": (32, 64, 128),                      # flash keys a block
    "lanes": (4, 8, 16, 32, 64, 128, 256, 512, 1024),   # threads a row
    "nv": (1, 2, 3, 4),                       # chunks a thread holds
}
SMOKE_KNOB_GRID = {
    "bn": (16, 32, 64),
    "split": (1, 2, 3, 4, 5, 6, 7, 8),
    "bq": (64, 128),
    "bk": (64, 128),
    "lanes": (32, 128, 256, 512),
    "nv": (2, 4),
}
# the fused routes' knobs are M-free: measured in, and selected from, the
# decode class at every M
KNOB_CLASS = {("matmul", "cuda_fused"): "gemm_decode",
              ("grouped_matmul", "cuda_grouped_fused"): "moe_experts"}

# -- the engine pseudo-op -----------------------------------------------------
ENGINE_OP = "engine"
ENGINE_ROUTE = "engine_step"
ENGINE_SHAPE_CLASS = "engine_ci"
ENGINE_POLICY = "kv4_attn8_packed"
ENGINE_DRAFT_POLICY = "w4a4_kv4_attn4"
ENGINE_CONFIG = "qwen3-4b"
ENGINE_POOL_ROWS = 384          # page_size * n_pages held constant
ENGINE_SEQ_ROWS = 48            # page_size * max_pages_per_req constant
ENGINE_KNOB_GRID = {"page_size": (8, 16), "spec_k": (0, 2, 4)}
SMOKE_ENGINE_KNOB_GRID = {"page_size": (8, 16), "spec_k": (0,)}
CPU_ENGINE_GEOMETRY = dict(pool_rows=ENGINE_POOL_ROWS,
                           seq_rows=ENGINE_SEQ_ROWS, max_batch=4,
                           token_budget=16, prefill_chunk=8)
# the serving phase's engine (chip_smoke.py phase 3a): 80 pages of 16
CARD_ENGINE_GEOMETRY = dict(pool_rows=1280, seq_rows=256, max_batch=4,
                            token_budget=64, prefill_chunk=32)

# the configurations whose shapes the sweep measures by default: the
# serving paths'
DEFAULT_CONFIGS = ("qwen3-4b", "granite-moe-1b-a400m")
L2_BYTES = 50 * 2 ** 20         # H100 L2: cold cutouts rotate past it
MAX_COPIES = 64


# -- shape classes ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeClass:
    """One equivalence class of resolve() contexts: `match(ctx)` decides
    membership at resolve time; `rep` is the class's representative ctx
    (the reference's), which a configuration's shapes complete."""
    op: str
    name: str
    match: Callable
    rep: dict


SHAPE_CLASSES = (
    ShapeClass("matmul", "gemm_decode",
               lambda ctx: ctx.get("m") is not None
               and 0 < ctx["m"] <= 16,
               dict(w_dtype="float32", m=8, k=128, n=128)),
    ShapeClass("matmul", "gemm_prefill",
               lambda ctx: ctx.get("m") is not None and ctx["m"] > 16,
               dict(w_dtype="float32", m=128, k=128, n=128)),
    ShapeClass("grouped_matmul", "moe_experts",
               lambda ctx: ctx.get("e") is not None,
               dict(w_dtype="float32", eq="gti,gio->gto", e=4, m=16,
                    k=64, n=64)),
    ShapeClass("flash_attn", "flash_prefill",
               lambda ctx: ctx.get("sq", 1) > 1
               and not ctx.get("has_valid", False),
               dict(sq=32, skv=32, use_flash=True, has_valid=False,
                    kv_on_grid=False)),
    ShapeClass("paged_decode", "paged_single",
               lambda ctx: ctx.get("n_devices", 1) <= 1,
               dict(batch=4, page_size=8, max_pages=6, kv_heads=2, hd=16,
                    n_pages=48, n_devices=1)),
    ShapeClass("verify_attn", "verify_paged",
               lambda ctx: ctx.get("n_devices", 1) <= 1,
               dict(batch=2, sq=4, page_size=8, max_pages=6, kv_heads=2,
                    hd=16, n_pages=48, n_devices=1)),
    ShapeClass("quantize_pack", "qp_fp4_pack",
               lambda ctx: ctx.get("fmt") == "fp4_e2m1"
               and ctx.get("pack", False),
               dict(fmt="fp4_e2m1", pack=True)),
    ShapeClass("quantize_pack", "qp_rows",
               lambda ctx: not ctx.get("pack", False),
               dict(fmt="fp8_e4m3", pack=False)),
)

# the policies whose shapes the sweep measures, per op: the serving paths'
# (quantize_pack routes ignore the policy: the ctx's fmt / pack drive them)
OP_POLICIES = {
    "matmul": ("w4a8_kv4_attn8", "fp4_dpa_packed"),
    "grouped_matmul": ("w4a8_kv4_attn8", "fp4_dpa_packed"),
    "flash_attn": ("w4a8_kv4_attn8", "fp8_dpa"),
    "paged_decode": ("w4a8_kv4_attn8",),
    "verify_attn": ("w4a8_kv4_attn8",),
    "quantize_pack": ("fp32",),
}


def classify(op: str, ctx: dict) -> Optional[str]:
    """Shape-class name for a live resolve ctx; None -> untuned prior."""
    for sc in SHAPE_CLASSES:
        if sc.op == op and sc.match(ctx):
            return sc.name
    return None


_SHAPE_FIELDS = {
    "matmul": ("k", "n"), "grouped_matmul": ("e", "k", "n"),
    "flash_attn": ("hd", "sq", "skv"),
    "paged_decode": ("batch", "kv_heads", "hd", "page_size", "max_pages"),
    "verify_attn": ("batch", "kv_heads", "hd", "page_size", "max_pages",
                    "sq"),
    "quantize_pack": ("m", "k"),
}


def shape_key(op: str, ctx: dict) -> Optional[list]:
    """The shape a record of `op` is keyed on, from a resolve ctx: [E, K,
    N] for the matmuls (E 1 dense), [hd, Sq, Skv] for flash, the cache
    geometry for the paged ops, [M, K] for the quantizers; None where the
    ctx does not carry it (-> the prior)."""
    fields = _SHAPE_FIELDS.get(op)
    if fields is None or any(ctx.get(f) is None for f in fields):
        return None
    shape = [int(ctx[f]) for f in fields]
    return [1] + shape if op == "matmul" else shape


# -- hashing ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _policy_digest(pol) -> str:
    blob = json.dumps(dataclasses.asdict(pol), sort_keys=True,
                      separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def policy_key(policy) -> str:
    """Stable 12-hex digest of a policy's full field set (preset names
    can drift; the fields are the semantics) — the reference's digest."""
    from repro_torch.core.policy import get_policy
    return _policy_digest(get_policy(policy if policy is not None
                                     else "fp32"))


ENV_FIELDS = ("torch", "cuda", "device")
HASH_FIELDS = ("op", "policy_key", "shape_class", "shape", "route",
               "knobs") + ENV_FIELDS


def config_hash(cfg) -> str:
    """Content hash of one measurement key (16 hex chars).  Key-order and
    whitespace invariant: only HASH_FIELDS take part, serialized
    canonically.  Accepts a dict or its JSON."""
    if isinstance(cfg, str):
        cfg = json.loads(cfg)
    knobs = dict(cfg.get("knobs") or {})
    canon = {"op": cfg["op"], "policy_key": cfg["policy_key"],
             "shape_class": cfg["shape_class"],
             "shape": list(cfg.get("shape") or []), "route": cfg["route"],
             "knobs": {k: knobs[k] for k in sorted(knobs)},
             **{f: cfg.get(f, "") for f in ENV_FIELDS}}
    blob = json.dumps(canon, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def shard_of(config_hash_hex: str, n_shards: int) -> int:
    """Deterministic shard index: every config lands in exactly one."""
    return int(config_hash_hex, 16) % n_shards


@functools.lru_cache(maxsize=None)
def env_fingerprint(device: Optional[str] = None) -> dict:
    """What decides a measurement: torch, CUDA and the device (the card's
    name, or "cpu").  `device` None: the card where there is one."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    name = (torch.cuda.get_device_name(torch.device(device))
            if str(device).startswith("cuda") else "cpu")
    return {"torch": torch.__version__, "cuda": torch.version.cuda or "",
            "device": name}


# -- measurement database -----------------------------------------------------

_WARNED: set = set()


def warn_once(msg: str) -> None:
    if msg not in _WARNED:
        _WARNED.add(msg)
        warnings.warn(msg, stacklevel=3)


_REQUIRED_RECORD_FIELDS = ("op", "policy_key", "shape_class", "route", "us")


def _valid_record(rec) -> bool:
    if not isinstance(rec, dict):
        return False
    if any(f not in rec for f in _REQUIRED_RECORD_FIELDS):
        return False
    if not isinstance(rec["us"], (int, float)) or rec["us"] <= 0:
        return False
    if rec.get("knobs") is not None and not isinstance(rec["knobs"], dict):
        return False
    if rec.get("shape") is not None and not isinstance(rec["shape"], list):
        return False
    return True


def load_db(path: str) -> dict:
    """Read a measurement DB, tolerating damage: a corrupt file gives an
    empty DB and corrupt or partial records are dropped, with one warning
    each, never an exception."""
    db = {"version": SCHEMA_VERSION, "meta": {}, "records": {}}
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return db
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
        warn_once(f"tuned DB {path!r} unreadable ({exc!r}); treating as "
                  "empty")
        return db
    if not isinstance(raw, dict) or not isinstance(raw.get("records"), dict):
        warn_once(f"tuned DB {path!r} has no records table; treating as "
                  "empty")
        return db
    db["meta"] = raw.get("meta") if isinstance(raw.get("meta"), dict) else {}
    dropped = 0
    for h, rec in raw["records"].items():
        if _valid_record(rec):
            db["records"][h] = rec
        else:
            dropped += 1
    if dropped:
        warn_once(f"tuned DB {path!r}: ignored {dropped} corrupt/partial "
                  "record(s)")
    return db


def save_db(path: str, db: dict) -> None:
    """Atomic write (tmp + rename): a killed sweep never leaves a
    half-written DB for `resolve` to trip on."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"version": SCHEMA_VERSION, "meta": db.get("meta", {}),
                   "records": db.get("records", {})},
                  f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


_DB_CACHE: dict = {}


def _load_db_cached(path: str, mtime_ns: int) -> dict:
    key = (os.path.abspath(path), mtime_ns)
    if key not in _DB_CACHE:
        _DB_CACHE.clear()        # one live DB at a time is the use case
        _DB_CACHE[key] = load_db(path)
    return _DB_CACHE[key]


# -- tuned selection (the resolve() consult) ----------------------------------

def _family(entry) -> set:
    """The reference family a route's numerics are held within."""
    return {n for n in (entry.name, entry.reference) if n is not None}


def _best_record(db: dict, op: str, pkey: str, cls: str, shape=None):
    """The fastest record for (op, policy key, class, shape) measured in
    this exact environment (`shape` None: any); records of another torch,
    CUDA or device are ignored with one warning.  Deterministic
    tie-break by (us, route, knobs)."""
    pool = [r for r in db["records"].values()
            if r["op"] == op and r["policy_key"] == pkey
            and r["shape_class"] == cls
            and (shape is None or r.get("shape") == list(shape))]
    fp = env_fingerprint()
    exact = [r for r in pool if all(r.get(f) == fp[f] for f in ENV_FIELDS)]
    if len(exact) < len(pool):
        other = sorted({tuple(str(r.get(f)) for f in ENV_FIELDS)
                        for r in pool} - {tuple(fp[f] for f in ENV_FIELDS)})
        warn_once(f"tuned DB: ignored {len(pool) - len(exact)} record(s) of "
                  f"{op}/{cls} measured under another (torch, cuda, device) "
                  f"{other}; this is {tuple(fp[f] for f in ENV_FIELDS)}")
    if not exact:
        return None
    return min(exact, key=lambda r: (
        r["us"], r["route"],
        json.dumps(dict(r.get("knobs") or {}), sort_keys=True)))


def _knobbed_run(base, knobs: dict) -> Callable:
    def run(*args, **kw):
        return base.run(*args, **{**kw, **knobs})
    return run


_ENTRY_CACHE: dict = {}


def tuned_entry(db_path: str, op: str, policy, ctx: dict, static):
    """-> a tuned PlanEntry for (op, policy, ctx), or None for the static
    prior.  Called by `exec_plan.resolve`; every failure degrades to None.
    Minted entries are memoized per (DB state, key), so repeated
    resolutions return the identical object."""
    cls = classify(op, ctx)
    if cls is None:
        return None
    shape = shape_key(op, ctx)
    if shape is None:
        return None
    from repro_torch.core.policy import get_policy
    pol = get_policy(policy if policy is not None else "fp32")
    pkey = policy_key(pol)
    try:
        mtime = os.stat(db_path).st_mtime_ns
    except OSError:
        warn_once(f"tuned DB {db_path!r} not readable; using the priority "
                  "order")
        return None
    key = (db_path, mtime, op, pkey, cls, tuple(shape), static.name)
    if key in _ENTRY_CACHE:
        cached = _ENTRY_CACHE[key]
        return cached if cached is not None and cached.eligible(pol, ctx) \
            else None
    entry = _mint(db_path, mtime, op, pol, cls, pkey, shape, static, ctx)
    _ENTRY_CACHE[key] = entry
    if entry is not None and not entry.eligible(pol, ctx):
        return None
    return entry


def _mint(db_path, mtime, op, pol, cls, pkey, shape, static, ctx):
    from repro_torch.core import exec_plan
    db = _load_db_cached(db_path, mtime)
    kcls = KNOB_CLASS.get((op, static.name), cls)
    rec = _best_record(db, op, pkey, kcls, shape)
    if rec is None:
        return None
    try:
        base = exec_plan.route(op, rec["route"])
    except exec_plan.PlanError:
        warn_once(f"tuned DB names unknown route {op}/{rec['route']}; using "
                  "the priority order")
        return None
    if not (_family(base) & _family(static)) or (
            static.backend == "cuda" and base.backend != "cuda"):
        warn_once(f"tuned route {op}/{base.name} is outside the static "
                  f"choice's reference family ({static.name}"
                  f"{', a kernel' if static.backend == 'cuda' else ''}); "
                  "using the priority order")
        return None
    if not base.eligible(pol, ctx):
        warn_once(f"tuned route {op}/{base.name} is not eligible at {ctx}; "
                  "using the priority order")
        return None
    knobs = dict(rec.get("knobs") or {})
    unknown = sorted(set(knobs) - set(base.knobs))
    if unknown:
        warn_once(f"tuned record for {op}/{base.name} carries unknown "
                  f"knob(s) {unknown}; using the priority order")
        return None
    if knobs:
        try:
            base.plan(pol, ctx, **knobs)
        except ValueError as exc:
            warn_once(f"tuned knobs {knobs} of {op}/{base.name} refused at "
                      f"{ctx} ({exc}); using the priority order")
            return None
    run = _knobbed_run(base, knobs) if knobs else base.run
    return dataclasses.replace(base, run=run, tuned=True, tuned_class=kcls,
                               tuned_knobs=tuple(sorted(knobs.items())))


def clear_caches() -> None:
    """Drop the DB and minted-entry caches and the warnings given."""
    _DB_CACHE.clear()
    _ENTRY_CACHE.clear()
    _WARNED.clear()


# -- the shapes of a configuration --------------------------------------------

def linear_shapes(cfg) -> dict:
    """{"dense": [(K, N), ...], "experts": [(E, K, N), ...]}: the distinct
    weight shapes of one decoder layer's attention projections and MLP
    (the experts' for a MoE config)."""
    d, hd = cfg.d_model, cfg.hd
    q_out, kv_out = cfg.n_heads * hd, cfg.n_kv_heads * hd
    dense = [(d, q_out), (d, kv_out), (q_out, d)]
    mlp = [(d, cfg.d_ff), (cfg.d_ff, d)] if cfg.d_ff else []
    experts = []
    if cfg.is_moe:
        experts = [(cfg.n_experts, k, n) for k, n in mlp]
    else:
        dense += mlp
    return {"dense": list(dict.fromkeys(dense)),
            "experts": list(dict.fromkeys(experts))}


def _sizes(reduced: bool) -> dict:
    """Rows the cutouts run at: the decode step's padded 8, a 4096-token
    pass (32 reduced), quantizer rows."""
    return dict(decode_m=8, prefill_m=128, seq=32 if reduced else 4096,
                qrows=128 if reduced else 4096)


def class_ctxs(sc: ShapeClass, cfg, reduced: bool) -> list:
    """Every resolve ctx of class `sc` a configuration's layers give (the
    class's representative ctx completed by the config's shapes)."""
    z = _sizes(reduced)
    shapes = linear_shapes(cfg)
    from repro_torch.models.registry import _DTYPES
    dtype = str(_DTYPES[cfg.dtype]).replace("torch.", "")
    # the paged ops at the engine's geometry (the engine pseudo-op's:
    # the reference's reduced, the serving phase's at full width)
    eng, ps = engine_geometry(reduced=reduced), 8 if reduced else 16
    geo = dict(page_size=ps, max_pages=eng["seq_rows"] // ps,
               n_pages=eng["pool_rows"] // ps, batch=eng["max_batch"])
    if sc.name in ("gemm_decode", "gemm_prefill"):
        m = z["decode_m"] if sc.name == "gemm_decode" else z["prefill_m"]
        return [dict(sc.rep, m=m, k=k, n=n, x_dtype=dtype)
                for k, n in shapes["dense"]]
    if sc.name == "moe_experts":
        return [dict(sc.rep, e=e, m=z["decode_m"], k=k, n=n, x_dtype=dtype)
                for e, k, n in shapes["experts"]]
    if sc.name == "flash_prefill":
        return [dict(sc.rep, sq=z["seq"], skv=z["seq"], hd=cfg.hd,
                     heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
                     x_dtype=dtype)]
    if sc.op in ("paged_decode", "verify_attn"):
        ctx = dict(sc.rep, kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                   heads=cfg.n_heads, x_dtype=dtype, **geo)
        if sc.op == "verify_attn":
            ctx["sq"] = 5                    # k = 4 drafts + 1
        return [ctx]
    if sc.op == "quantize_pack":
        ks = [cfg.d_model] + ([cfg.d_ff] if cfg.d_ff else [])
        return [dict(sc.rep, m=z["qrows"], k=k, x_dtype=dtype) for k in ks]
    return []


def _load_config(name: str, reduced: bool):
    from repro_torch.configs import get_config, reduce_config
    cfg = get_config(name)
    return reduce_config(cfg) if reduced else cfg


# -- config-space enumeration -------------------------------------------------

def _prior(op: str, pol, ctx: dict):
    """The priority scan alone (whatever DB is active)."""
    from repro_torch.core import exec_plan
    for entry in exec_plan.candidates(op):
        if entry.eligible(pol, ctx):
            return entry
    raise exec_plan.PlanError(f"no {op} route at {ctx}")


def knob_combos(route, pol, ctx: dict, grid: dict) -> list:
    """The knob dicts of `route` worth measuring at ctx: the static plan
    ({}), then every grid combination the route's `plan` takes at ctx
    whose launch differs from every earlier one (deterministic order)."""
    if not route.knobs:
        return [{}]
    combos = [{}]
    for name in sorted(route.knobs):
        combos = [dict(c, **{name: v}) for c in combos
                  for v in grid.get(name, ())]
    out, seen = [{}], {route.plan(pol, ctx)}
    for c in combos:
        try:
            p = route.plan(pol, ctx, **c)
        except ValueError:
            continue
        if p not in seen:
            seen.add(p)
            out.append(c)
    return out


def engine_geometry(device: str = "cpu", reduced: Optional[bool] = None):
    """The engine pseudo-op's geometry: the reference's for the reduced
    fixture (the CPU's default), the serving phase's at full width."""
    reduced = (device == "cpu") if reduced is None else reduced
    return CPU_ENGINE_GEOMETRY if reduced else CARD_ENGINE_GEOMETRY


def engine_points(egrid: dict):
    """-> the engine pseudo-op's knob points, every (page_size, spec_k) of
    `egrid`: the speculative ones run on the card as on the CPU (the
    verify pass keeps the decode steps' bits on every linear route,
    `models.layers`)."""
    return [{"page_size": ps, "spec_k": k}
            for ps in egrid["page_size"] for k in egrid["spec_k"]]


def enumerate_space(smoke: bool = False, ops=None, policies=None,
                    configs=DEFAULT_CONFIGS, device: str = "cpu",
                    reduced: Optional[bool] = None) -> list:
    """The config space: one dict per (op, policy, shape class, shape,
    route, knob combination) the tuned consult could select, for the
    layer shapes of `configs` (reduced by default on the CPU).  Routes
    are kept where eligible at the shape, inside the static choice's
    family and, where the static choice is a kernel, kernels; a route's
    M-free knobs only in their class (`KNOB_CLASS`)."""
    from repro_torch.core.policy import get_policy
    reduced = (device == "cpu") if reduced is None else reduced
    grid = SMOKE_KNOB_GRID if smoke else KNOB_GRID
    fp = env_fingerprint(device)
    space, seen = [], set()

    def add(cfg):
        h = config_hash(cfg)
        if h not in seen:
            seen.add(h)
            space.append(cfg)

    from repro_torch.core import exec_plan
    for name in configs:
        mcfg = _load_config(name, reduced)
        for sc in SHAPE_CLASSES:
            if ops is not None and sc.op not in ops:
                continue
            for preset in OP_POLICIES.get(sc.op, ()):
                if policies is not None and preset not in policies:
                    continue
                pol = get_policy(preset)
                for ctx in class_ctxs(sc, mcfg, reduced):
                    try:
                        static = _prior(sc.op, pol, ctx)
                    except exec_plan.PlanError:
                        continue
                    for route in exec_plan.candidates(sc.op):
                        if not route.eligible(pol, ctx) or not (
                                _family(route) & _family(static)) or (
                                static.backend == "cuda"
                                and route.backend != "cuda"):
                            continue
                        kcls = KNOB_CLASS.get((sc.op, route.name))
                        if kcls is not None and kcls != sc.name:
                            continue
                        for knobs in knob_combos(route, pol, ctx, grid):
                            add({"op": sc.op, "policy": preset,
                                 "policy_key": policy_key(pol),
                                 "shape_class": sc.name,
                                 "shape": shape_key(sc.op, ctx),
                                 "route": route.name, "knobs": knobs,
                                 "config": name, "ctx": ctx, **fp})
    if (ops is None or ENGINE_OP in ops) and \
            (policies is None or ENGINE_POLICY in policies):
        geometry = engine_geometry(device, reduced)
        egrid = SMOKE_ENGINE_KNOB_GRID if smoke else ENGINE_KNOB_GRID
        for knobs in engine_points(egrid):
            add({"op": ENGINE_OP, "policy": ENGINE_POLICY,
                 "policy_key": policy_key(ENGINE_POLICY),
                 "shape_class": ENGINE_SHAPE_CLASS,
                 "shape": [ENGINE_CONFIG, int(reduced),
                           geometry["pool_rows"], geometry["seq_rows"]],
                 "route": ENGINE_ROUTE, "knobs": knobs,
                 "config": ENGINE_CONFIG, "ctx": dict(geometry), **fp})
    return space


# -- cutout synthesis + measurement -------------------------------------------

def _gen(device, seed):
    import torch
    return torch.Generator(device=device).manual_seed(seed)


def _randn(shape, gen, device, dtype="float32"):
    import torch
    return torch.randn(shape, generator=gen, device=device).to(
        getattr(torch, dtype))


def _copies(lin: dict, cold: bool) -> list:
    """`lin` and, cold, enough copies of its load-time weights that the
    calls rotating over them stream past the L2."""
    if not cold:
        return [lin]
    nbytes = sum(t.numel() * t.element_size() for key, t in lin.items()
                 if key in ("wq", "sw"))
    n = min(MAX_COPIES, max(2, -(-2 * L2_BYTES // max(1, nbytes)) + 1))
    return [lin] + [dict(lin, wq=lin["wq"].clone(), sw=lin["sw"].clone())
                    for _ in range(n - 1)]


def cutout(cfg: dict, device: str = "cpu"):
    """-> (calls, cold): zero-argument callables running the config's
    route with its knobs at its shape (one a weight copy where the op
    streams weights and the device is the card, so `cold`)."""
    import torch

    from repro_torch.core import exec_plan
    from repro_torch.core.linear import (prepare_grouped_linear,
                                         prepare_linear)
    from repro_torch.core.policy import get_policy
    op, ctx, knobs = cfg["op"], cfg["ctx"], dict(cfg.get("knobs") or {})
    pol = get_policy(cfg["policy"])
    entry = exec_plan.route(op, cfg["route"])
    dtype = ctx.get("x_dtype", "float32")
    on_card = str(device).startswith("cuda")
    if op in ("matmul", "grouped_matmul"):
        g = _gen(device, 0)
        lead = (ctx["e"],) if op == "grouped_matmul" else ()
        x = _randn(lead + (ctx["m"], ctx["k"]), g, device, dtype)
        w = _randn(lead + (ctx["k"], ctx["n"]), g, device) * ctx["k"] ** -0.5
        lin = {"w": w}
        if entry.backend == "cuda":
            if op == "matmul":
                prepare_linear(lin, pol, getattr(torch, dtype))
            else:
                prepare_grouped_linear(lin, pol)
        kw = {"eq": ctx["eq"]} if op == "grouped_matmul" else {}
        cold = on_card and entry.backend == "cuda"
        return [functools.partial(entry.run, x, c, pol, **kw, **knobs)
                for c in _copies(lin, cold)], cold
    if op == "flash_attn":
        g = _gen(device, 1)
        S, hd = ctx["sq"], ctx["hd"]
        q = _randn((1, S, ctx["heads"], hd), g, device, dtype)
        k = _randn((1, ctx["skv"], ctx["kv_heads"], hd), g, device, dtype)
        v = _randn((1, ctx["skv"], ctx["kv_heads"], hd), g, device, dtype)
        return [functools.partial(
            entry.run, q, k, v, policy=pol, causal=True, window=None,
            offset=0, valid=None, scale=hd ** -0.5, kv_on_grid=False,
            **knobs)], False
    if op in ("paged_decode", "verify_attn"):
        from repro_torch.core import kvcache as KV
        g = _gen(device, 2)
        B, ps, mp = ctx["batch"], ctx["page_size"], ctx["max_pages"]
        n_kv, hd, sq = ctx["kv_heads"], ctx["hd"], ctx.get("sq", 1)
        S = mp * ps
        k = _randn((B, S, n_kv, hd), g, device)
        v = _randn((B, S, n_kv, hd), g, device)
        ref = KV.init_kv_cache(B, S, n_kv, hd, fmt=pol.fmt_kv,
                               packed=pol.kv_packed, device=device)
        KV.update_kv_cache(ref, k, v, 0, fmt=pol.fmt_kv, packed=pol.kv_packed)
        cache = KV.paged_from_contiguous(ref, [S] * B, page_size=ps)
        q = _randn((B, sq, ctx["heads"], hd), g, device, dtype)
        positions = torch.full((B,), S - sq, dtype=torch.int32,
                               device=device)
        return [functools.partial(entry.run, q, cache, positions, policy=pol,
                                  scale=hd ** -0.5, **knobs)], False
    if op == "quantize_pack":
        x = _randn((ctx["m"], ctx["k"]), _gen(device, 3), device, dtype)
        return [functools.partial(entry.run, x, fmt=ctx["fmt"],
                                  pack=ctx["pack"], **knobs)], False
    raise KeyError(f"no cutout for op {op!r}")


def _time_cuda(calls, reps: int) -> dict:
    """CUDA events around `reps` replays of one graph holding `calls`
    (after a warm-up): the median us a call, the spread (max - min) /
    median of the replays.  Where the calls cannot be captured, events
    around the calls run eagerly ("graph": False)."""
    import torch
    for c in calls:
        c()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for c in calls:
            c()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for c in calls:
                c()
        run, graphed = graph.replay, True
    except RuntimeError:          # not capturable: timed eagerly
        torch.cuda.synchronize()

        def run():
            for c in calls:
                c()
        graphed = False
    run()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        a.record()
        run()
        b.record()
    torch.cuda.synchronize()
    per = [a.elapsed_time(b) * 1e3 / len(calls) for a, b in events]
    del graph
    med = statistics.median(per)
    return {"us": med, "reps": reps, "calls": len(calls),
            "spread": (max(per) - min(per)) / med, "graph": graphed}


def _time_cpu(calls, reps: int) -> dict:
    calls[0]()
    per = []
    for i in range(reps):
        t0 = time.perf_counter()
        calls[i % len(calls)]()
        per.append((time.perf_counter() - t0) * 1e6)
    med = statistics.median(per)
    return {"us": med, "reps": reps, "calls": 1,
            "spread": (max(per) - min(per)) / med}


def default_reps(device: str) -> int:
    return 25 if str(device).startswith("cuda") else 3


def measure_config(cfg: dict, reps: Optional[int] = None,
                   device: str = "cpu", engine_fixture=None) -> dict:
    """Measure one config as an isolated cutout -> {"us" a call (a
    generated token for the engine), "reps", "spread", ...}."""
    reps = reps or default_reps(device)
    if cfg["op"] == ENGINE_OP:
        return _measure_engine(cfg, reps, device, engine_fixture)
    calls, cold = cutout(cfg, device)
    timed = (_time_cuda(calls, reps) if str(device).startswith("cuda")
             else _time_cpu(calls, reps))
    return dict(timed, cold=cold)


_ENGINE_FIXTURE: dict = {}


def engine_fixture(device: str = "cpu", reduced: Optional[bool] = None):
    """(model, params) of the engine pseudo-op under `ENGINE_POLICY`,
    built once per (device, reduced): reduced qwen3-4b on the CPU,
    qwen3-4b at full width on the card."""
    import torch

    from repro_torch.models import build_model
    reduced = (device == "cpu") if reduced is None else reduced
    key = (str(device), reduced)
    if key not in _ENGINE_FIXTURE:
        cfg = _load_config(ENGINE_CONFIG, reduced).replace(
            policy=ENGINE_POLICY)
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        _ENGINE_FIXTURE[key] = (model, params)
    return _ENGINE_FIXTURE[key]


def engine_config_from_knobs(knobs: dict, geometry: Optional[dict] = None):
    """-> (EngineConfig, SpecConfig or None) for one engine knob point.
    Pool rows and per-request rows stay constant across page sizes, so
    the sweep compares layouts, not capacities."""
    from repro_torch.launch.engine import EngineConfig
    from repro_torch.serving.spec_decode import SpecConfig
    geo = geometry or CPU_ENGINE_GEOMETRY
    ps = int(knobs.get("page_size", 8))
    if geo["pool_rows"] % ps or geo["seq_rows"] % ps:
        raise ValueError(f"page_size {ps} must divide {geo['pool_rows']} / "
                         f"{geo['seq_rows']}")
    ecfg = EngineConfig(page_size=ps, n_pages=geo["pool_rows"] // ps,
                        max_batch=geo["max_batch"],
                        max_pages_per_req=geo["seq_rows"] // ps,
                        token_budget=geo["token_budget"],
                        prefill_chunk=geo["prefill_chunk"])
    k = int(knobs.get("spec_k", 0))
    spec = SpecConfig(ENGINE_DRAFT_POLICY, k=k) if k > 0 else None
    return ecfg, spec


def _measure_engine(cfg: dict, reps: int, device: str, fixture) -> dict:
    """Whole-engine cutout: the fixed synthetic workload through a warm
    engine (graphed on the card); the best of `reps` runs' us a generated
    token (knob points generate different token counts under spec)."""
    import torch

    from repro_torch.launch.engine import Engine, synthetic_workload
    model, params = fixture or engine_fixture(device)
    vocab = model.cfg.vocab_size
    ecfg, spec = engine_config_from_knobs(cfg["knobs"], cfg["ctx"])
    engine = Engine(model, params, ecfg, spec=spec, device=device)
    engine.run(synthetic_workload(2, vocab=vocab, seed=1,
                                  prompt_range=(8, 24), gen_range=(4, 10)))
    runs = min(reps, 3)
    per = []
    for _ in range(runs):
        reqs = synthetic_workload(6, vocab=vocab, seed=0,
                                  prompt_range=(8, 24), gen_range=(4, 10))
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = engine.run(reqs)
        if device != "cpu":
            torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e6
                   / max(1, rep["gen_tokens"]))
    del engine
    best = min(per)
    return {"us": best, "reps": runs, "calls": 1,
            "spread": (max(per) - best) / best}


def best_engine_knobs(db_path: str) -> Optional[dict]:
    """Fastest measured engine knob point in the DB for this environment
    (None if none)."""
    db = load_db(db_path)
    rec = _best_record(db, ENGINE_OP, policy_key(ENGINE_POLICY),
                       ENGINE_SHAPE_CLASS)
    return dict(rec.get("knobs") or {}) if rec else None


# -- the sweep ----------------------------------------------------------------

def run_sweep(db_path: str, *, smoke: bool = False, shard=(0, 1),
              reps: Optional[int] = None, ops=None, policies=None,
              configs=DEFAULT_CONFIGS, device: str = "cpu",
              reduced: Optional[bool] = None, progress: Callable = None,
              measure: Callable = None, engine_fixture=None) -> dict:
    """Measure this shard's unmeasured slice of the space into `db_path`.
    -> {"measured", "skipped", "other_shard", "total"}.  `measure(cfg,
    reps)` replaces `measure_config` (tests)."""
    i, n = shard
    if not (0 <= i < n):
        raise ValueError(f"bad shard {i}/{n}")
    space = enumerate_space(smoke=smoke, ops=ops, policies=policies,
                            configs=configs, device=device, reduced=reduced)
    reps = reps or default_reps(device)
    db = load_db(db_path)
    stats = {"measured": 0, "skipped": 0, "other_shard": 0,
             "total": len(space)}
    for cfg in space:
        h = config_hash(cfg)
        if shard_of(h, n) != i:
            stats["other_shard"] += 1
            continue
        if h in db["records"]:
            stats["skipped"] += 1
            continue
        got = (measure(cfg, reps) if measure is not None else
               measure_config(cfg, reps, device,
                              engine_fixture=engine_fixture))
        db["records"][h] = {**cfg, **got}
        db["meta"] = env_fingerprint(device)
        stats["measured"] += 1
        if progress:
            progress(cfg, got)
        save_db(db_path, db)         # crash-safe: keep what was measured
    return stats


def missing_configs(db_path: str, *, smoke: bool = False, **space) -> list:
    """Configs of the (smoke) space with no record in the DB."""
    db = load_db(db_path)
    return [cfg for cfg in enumerate_space(smoke=smoke, **space)
            if config_hash(cfg) not in db["records"]]
