"""Sampled decoding, the prefix cache and the front end of the port's
serving engine, against the JAX reference where it has a counterpart.

Sampled engine: the reduced qwen3-4b under `kv4_attn8_packed`, with the
geometry of `tests/test_torch_engine.py` and `SamplerConfig(0.8,
top_k=20, top_p=0.9, seed=7)`, gives every request the same tokens as
the JAX `Engine` on the same converted weights (the port draws from the
reference's own threefry streams, `tests/test_torch_sampler.py`).  The
smallest decision margin over every row the port drew in that run (top-1
minus top-2 of gumbel + filtered logits, idle slots included) measured
0.0635, against logit differences of ~4.5e-7 (`tests/test_torch_model.py`)
and gumbel differences of an ulp; the test holds it above 1e-3.  A
request served alone gets its in-batch tokens, and another seed changes
them.

Prefix cache: the port's trie replays an operation sequence with the
same matches, inserts, evictions, refcounts and free list as the
reference's `PrefixCache`; a warm engine's tokens equal a cold one's bit
for bit (greedy and sampled), with the refcount invariants checked at
every scheduler tick and the copy-on-write source left untouched, as
`tests/test_prefix_cache.py` pins the reference.

Front end: `launch.serve.main` with `--device cpu` prints the report
lines in both modes, the speculation flags (`--spec-draft`, `--spec-k`,
`--adaptive-draft`) serve and print their report lines, and every flag
whose module is not ported exits naming its ROADMAP item.
"""
import contextlib
import functools
import importlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import serve as TSV  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.serving import sampler as TS  # noqa: E402
from repro_torch.serving import threefry as TF  # noqa: E402
from repro_torch.serving.prefix_cache import PrefixCache  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RE = importlib.import_module("repro.launch.engine")
RS = importlib.import_module("repro.serving.sampler")
RKV = importlib.import_module("repro.core.kvcache")
RPC = importlib.import_module("repro.serving.prefix_cache")

POLICY = "kv4_attn8_packed"
GEOM = dict(page_size=8, n_pages=32, max_batch=3, max_pages_per_req=4,
            token_budget=8, prefill_chunk=8)
LENS = [(9, 5), (14, 7), (5, 4), (20, 6), (11, 8)]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
MARGIN_FLOOR = 1e-3


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference under 32-bit JAX, its serving setting: a module
    imported earlier in the same process may have turned x64 on
    (`repro.core.dpa` does on import)."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _pair():
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(
        policy=POLICY)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tcfg = reduce_config(get_config("qwen3-4b")).replace(policy=POLICY)
    tmodel = build_model(tcfg, device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def _requests(mod, lens=LENS, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, 256, size=s0)
                        .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(lens)]


@contextlib.contextmanager
def _margins():
    """Record, for every row the engine draws, top-1 minus top-2 of
    gumbel + filtered logits under the row's own key."""
    seen, draw = [], TE.sample_tokens

    def recorded(logits, rids, positions, cfg, role=TS.ROLE_SAMPLE):
        if not cfg.greedy:
            keys = TS.request_key(cfg.seed, rids, positions, role)
            z = TF.gumbel(keys, logits.shape[-1]) + TS.filter_logits(
                logits, cfg)
            top = torch.topk(z, 2, dim=-1).values
            seen.extend((top[:, 0] - top[:, 1]).tolist())
        return draw(logits, rids, positions, cfg, role)

    TE.sample_tokens = recorded
    try:
        yield seen
    finally:
        TE.sample_tokens = draw


def _port_engine(seed=7, reqs=None, **ecfg):
    _, _, tmodel, tparams = _pair()
    engine = TE.Engine(tmodel, tparams,
                       TE.EngineConfig(**dict(GEOM, **ecfg)),
                       sampler=TS.SamplerConfig(seed=seed, **SAMPLED),
                       device="cpu")
    reqs = _requests(TE) if reqs is None else reqs
    return engine, reqs, engine.run(reqs)


@functools.lru_cache(maxsize=None)
def _sampled(seed):
    rmodel, rparams, _, _ = _pair()
    with _margins() as seen:
        engine, reqs, rep = _port_engine(seed)
    ref = RE.Engine(rmodel, rparams, RE.EngineConfig(**GEOM),
                    sampler=RS.SamplerConfig(seed=seed, **SAMPLED))
    rreqs = _requests(RE)
    ref.run(rreqs)
    return engine, reqs, rep, rreqs, min(seen)


# -----------------------------------------------------------------------------
# sampled decoding
# -----------------------------------------------------------------------------

def test_sampled_engine_equals_jax_engine():
    engine, reqs, rep, rreqs, margin = _sampled(7)
    for a, b in zip(reqs, rreqs):
        assert a.rid == b.rid and a.out_tokens == b.out_tokens, a.rid
    assert all(r.n_generated == r.max_new for r in reqs)
    assert margin > MARGIN_FLOOR
    assert rep["temperature"] == 0.8 and engine.alloc.in_use == 0


def test_request_alone_gets_its_batch_tokens():
    _, served, _, _, _ = _sampled(7)
    for i in (1, 3):
        alone = _requests(TE)[i]
        _port_engine(7, reqs=[alone])
        assert alone.out_tokens == served[i].out_tokens, i


def test_other_seed_changes_the_tokens():
    _, a, _, _, _ = _sampled(7)
    _, b, _ = _port_engine(8)
    assert [r.out_tokens for r in a] != [r.out_tokens for r in b]
    assert sum(x.out_tokens != y.out_tokens for x, y in zip(a, b)) >= 3


def test_temperature_zero_config_serves_greedy_tokens():
    _, _, tmodel, tparams = _pair()
    greedy = TE.Engine(tmodel, tparams, TE.EngineConfig(**GEOM),
                       device="cpu")
    gr = _requests(TE)
    greedy.run(gr)
    zero = TE.Engine(tmodel, tparams, TE.EngineConfig(**GEOM),
                     sampler=TS.SamplerConfig(seed=7, top_k=50),
                     device="cpu")
    zr = _requests(TE)
    zero.run(zr)
    assert [r.out_tokens for r in gr] == [r.out_tokens for r in zr]


def test_workload_stream_with_shared_prefix_and_mixed():
    for kw in (dict(shared_prefix=12), dict(mixed=0.5),
               dict(shared_prefix=5, mixed=0.3, rate=40.0)):
        got = TE.synthetic_workload(9, vocab=256, seed=4,
                                    prompt_range=(4, 12), gen_range=(2, 5),
                                    **kw)
        want = RE.synthetic_workload(9, vocab=256, seed=4,
                                     prompt_range=(4, 12), gen_range=(2, 5),
                                     **kw)
        for a, b in zip(got, want):
            assert np.array_equal(a.prompt, b.prompt), kw
            assert (a.max_new, a.arrival) == (b.max_new, b.arrival), kw
    prefixed = TE.synthetic_workload(5, vocab=256, seed=4, shared_prefix=6)
    assert all(np.array_equal(p.prompt[:6], prefixed[0].prompt[:6])
               for p in prefixed)


# -----------------------------------------------------------------------------
# the prefix trie against the reference's
# -----------------------------------------------------------------------------

def test_prefix_trie_replays_the_reference():
    ps, rng = 4, np.random.default_rng(0)
    t_alloc, r_alloc = TKV.PageAllocator(40), RKV.PageAllocator(40)
    tpc, rpc = PrefixCache(ps, t_alloc), RPC.PrefixCache(ps, r_alloc)
    owners = []                    # pages requests still hold
    for step in range(300):
        op = rng.integers(0, 4)
        if op == 0 and t_alloc.n_available >= 5:
            prompt = rng.integers(0, 3, size=int(rng.integers(1, 19)))
            n = -(-len(prompt) // ps)
            tp, rp = t_alloc.alloc(n), r_alloc.alloc(n)
            assert tp == rp
            assert tpc.insert(prompt, tp) == rpc.insert(prompt, rp)
            owners.append(tp)
        elif op == 1:
            prompt = rng.integers(0, 3, size=int(rng.integers(1, 19)))
            limit = int(rng.integers(0, len(prompt) + 2))
            a, b = tpc.match(prompt, limit), rpc.match(prompt, limit)
            assert (a.pages, a.cow, a.tokens) == (b.pages, b.cow, b.tokens)
        elif op == 2:
            n = int(rng.integers(1, 4))
            assert tpc.evict(n) == rpc.evict(n)
        elif owners:
            pages = owners.pop(int(rng.integers(0, len(owners))))
            t_alloc.free(pages)
            r_alloc.free(pages)
        assert tpc.n_pages == rpc.n_pages, step
        assert t_alloc._free == r_alloc._free, step
        assert all(t_alloc.refcount(p) == r_alloc.refcount(p)
                   for p in range(40)), step
    for pages in owners:
        t_alloc.free(pages)
        r_alloc.free(pages)
    assert tpc.drop_all() == rpc.drop_all()
    assert t_alloc.in_use == r_alloc.in_use == 0


@pytest.mark.parametrize("fmt,packed", [("fp4_e2m1", True),
                                        ("fp4_e2m1", False),
                                        ("fp8_e4m3", False), ("fp16", False)])
def test_gather_page_rows_inverts_the_scatter(fmt, packed):
    """The warm start's staging load: rows gathered from a request's pages
    equal the contiguous rows scattered there, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    ref = TKV.init_kv_cache(1, 21, 2, 8, fmt=fmt, packed=packed)
    TKV.update_kv_cache(ref, torch.randn((1, 21, 2, 8), generator=gen),
                        torch.randn((1, 21, 2, 8), generator=gen), 0,
                        fmt=fmt, packed=packed)
    pool = TKV.init_paged_kv_cache(10, 8, 2, 8, fmt=fmt, packed=packed)
    pages = [3, 7, 2]
    TKV.write_prefill_rows(pool, {k: ref[k][0] for k in TKV.QUANT_KEYS},
                           pages, 21)
    for m in (1, 8, 13, 21):
        rows = TKV.gather_page_rows(pool, pages, m)
        for k in TKV.QUANT_KEYS:
            want = ref[k][0, :m]
            assert rows[k].dtype == want.dtype and rows[k].shape == want.shape
            assert torch.equal(rows[k].view(torch.uint8),
                               want.contiguous().view(torch.uint8)), (m, k)
    with pytest.raises(ValueError, match="pages"):
        TKV.gather_page_rows(pool, pages[:2], 17)


# -----------------------------------------------------------------------------
# the engine's prefix cache: warm equals cold
# -----------------------------------------------------------------------------

def _shared_prefix_requests(seed=7):
    """A (20 tokens), B (A's first 12, diverging mid page 1: copy-on-
    write), C (A's first 16, diverging on the page boundary: a two-page
    hit), as `tests/test_prefix_cache.py`."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=20).astype(np.int32)
    b = a.copy()
    b[12:] = rng.integers(0, 256, size=8)
    c = a.copy()
    c[16:] = rng.integers(0, 256, size=4)
    return [TE.Request(rid=i, prompt=p.copy(), max_new=5)
            for i, p in enumerate((a, b, c))]


def _walk(root):
    out, stack = [], list(root.children.values())
    while stack:
        nd = stack.pop()
        stack.extend(nd.children.values())
        out.append(nd)
    return out


def _check_invariants(engine):
    """Refcounts equal the true holders: each live request once per page,
    the cache once per resident node; nothing leaks."""
    alloc = engine.alloc
    assert alloc.in_use + alloc.n_free == alloc.capacity - 1
    holders = {}
    for r in (s for s in engine.slots if s is not None):
        assert len(set(r.pages)) == len(r.pages)
        for p in r.pages:
            holders[p] = holders.get(p, 0) + 1
    nodes = _walk(engine.prefix.root)
    assert len(nodes) == engine.prefix.n_nodes
    for nd in nodes:
        holders[nd.page] = holders.get(nd.page, 0) + 1
    for p, n in holders.items():
        assert alloc.refcount(p) == n, p
    assert alloc.in_use == len(holders)


@pytest.mark.parametrize("sampler", [None, TS.SamplerConfig(seed=7,
                                                            **SAMPLED)])
def test_prefix_warm_equals_cold_tick_by_tick(sampler):
    _, _, tmodel, tparams = _pair()
    warm = TE.Engine(tmodel, tparams,
                     TE.EngineConfig(**dict(GEOM, prefix_cache=True)),
                     sampler=sampler, device="cpu")
    cold = TE.Engine(tmodel, tparams, TE.EngineConfig(**GEOM),
                     sampler=sampler, device="cpu")

    def run_one(req):
        warm.submit(req)
        now = 0.0
        while warm.waiting or any(warm.slots):
            warm.step(now)
            _check_invariants(warm)
            now += 1.0

    reqs = _shared_prefix_requests()
    run_one(reqs[0])
    shared = [nd.page for nd in _walk(warm.prefix.root)]
    snap = [{k: c[k][shared].clone() for k in TKV.QUANT_KEYS}
            for c in warm.caches]
    run_one(reqs[1])                           # copy-on-write mid page
    for c, s in zip(warm.caches, snap):
        for k in TKV.QUANT_KEYS:
            assert torch.equal(c[k][shared], s[k]), k   # source untouched
    run_one(reqs[2])                           # a two-page hit
    for r in _shared_prefix_requests():
        cold.run([r])
    want = {r.rid: r.out_tokens for r in cold.finished}
    for r in warm.finished:
        assert r.out_tokens == want[r.rid], r.rid
    assert warm.prefix_queries == 3 and warm.prefix_hits == 2
    assert warm.prefill_tokens_saved == 12 + 16 and warm.cow_copies == 1
    assert warm.alloc.in_use == warm.prefix.n_pages > 0
    rep = warm.report(1.0)
    assert rep["prefix_hit_rate"] == pytest.approx(2 / 3)
    assert rep["resident_prefix_bytes"] > 0
    text = TE.format_report(rep, POLICY)
    assert "prefix: 2/3 hits" in text and "28 prefill tokens saved" in text
    assert "prefix_hit_rate" not in cold.report(1.0)
    warm.prefix.drop_all()
    assert warm.alloc.in_use == 0


def test_prefix_batch_of_shared_prompts_and_eviction():
    """A shared-prefix workload served in one batch equals the cold
    engine's tokens; a pool too small for residents plus new requests
    evicts cold prefixes instead of stalling."""
    _, _, tmodel, tparams = _pair()
    reqs = TE.synthetic_workload(6, vocab=256, seed=2, prompt_range=(4, 9),
                                 gen_range=(2, 4), shared_prefix=11)
    cold_reqs = TE.synthetic_workload(6, vocab=256, seed=2,
                                      prompt_range=(4, 9), gen_range=(2, 4),
                                      shared_prefix=11)
    warm = TE.Engine(tmodel, tparams, TE.EngineConfig(**dict(
        GEOM, prefix_cache=True, n_pages=12)), device="cpu")
    cold = TE.Engine(tmodel, tparams, TE.EngineConfig(**GEOM), device="cpu")
    rep = warm.run(reqs)
    cold.run(cold_reqs)
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in cold_reqs]
    assert rep["prefix_hits"] >= 3 and rep["prefill_tokens_saved"] > 0
    # a second wave of unrelated prompts must evict the residents
    freed, evict = [], warm.prefix.evict

    def counted(n):
        freed.append(evict(n))
        return freed[-1]

    warm.prefix.evict = counted
    more = TE.synthetic_workload(3, vocab=256, seed=9, prompt_range=(20, 20),
                                 gen_range=(4, 4))
    warm.run(more)
    assert len(warm.finished) == 9 and sum(freed) > 0
    warm.prefix.drop_all()
    assert warm.alloc.in_use == 0


# -----------------------------------------------------------------------------
# the front end
# -----------------------------------------------------------------------------

def _main(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = TSV.main(["--arch", "qwen3-4b", "--reduced", "--device",
                           "cpu", *argv])
    return result, out.getvalue()


def test_front_end_engine_mode_prints_the_report():
    rep, text = _main("--engine", "--policy", "w4a8_kv4_attn8",
                      "--requests", "4", "--prompt-len", "12", "--gen", "4",
                      "--page-size", "8", "--prefill-chunk", "8",
                      "--temperature", "0.8", "--top-k", "50", "--top-p",
                      "0.95", "--shared-prefix", "10", "--prefix-cache",
                      "--max-batch", "2")
    for line in ("engine: 4 reqs", "latency: p50", "ttft p50",
                 "kv-cache: peak live", "plan: decode via cuda_block_table",
                 "prefix: ", "sample (req "):
        assert line in text, line
    assert rep["temperature"] == 0.8 and rep["n_requests"] == 4
    assert rep["prefix_queries"] == 4 and rep["prefix_hits"] >= 2
    assert rep["device"] == "cpu" and rep["graphs"] is False


def test_front_end_static_mode_and_moe_line():
    out, text = _main("--batch", "2", "--prompt-len", "6", "--gen", "3",
                      "--eager")
    assert tuple(out.shape) == (2, 9)
    assert "kv-cache:" in text and "plan: " in text
    assert "generated (2, 9)" in text
    moe_out = io.StringIO()
    with contextlib.redirect_stdout(moe_out):
        rep = TSV.main(["--arch", "granite-moe-1b-a400m", "--reduced",
                        "--device", "cpu", "--engine", "--policy",
                        "w4a8_kv4_attn8", "--requests", "2", "--prompt-len",
                        "6", "--gen", "2", "--page-size", "8",
                        "--prefill-chunk", "8"])
    assert "moe: 8 experts top-2" in moe_out.getvalue()
    assert rep["moe_grouped_route"] == "cuda_grouped_fused"


@pytest.mark.parametrize("flags,says", [
    pytest.param(("--engine", "--tp", "2"), "--dist-backend nccl or gloo",
                 id="tp-without-backend"),
    pytest.param(("--n-model", "2",),
                 "ROADMAP Queue 1, \"Model-parallel serving and training "
                 "(`--n-model`)\"",
                 id="flags4-Model-parallel serving and training")])
def test_front_end_refuses_unported_flags(flags, says):
    with pytest.raises(SystemExit) as exc:
        _main(*flags)
    assert says in str(exc.value)


def test_front_end_serves_tp_over_gloo(tmp_path):
    """`--engine --tp 2 --dist-backend gloo` on the CPU: two spawned ranks
    (a file store under tmp_path) serve the tp=1 tokens; rank 0's report
    says tp 2 and the sharded route."""
    flags = ENGINE_SMALL + ("--policy", "kv4_attn8_packed")
    rep1, text1 = _main(*flags)
    tokens1 = TSV.run_engine.last_tokens
    rep2, text2 = _main(*flags, "--tp", "2", "--dist-backend", "gloo",
                        "--dist-init", f"file://{tmp_path / 'store'}")
    assert TSV.run_engine.last_tokens == tokens1 and len(tokens1) == 3
    sample = [ln for ln in text1.splitlines() if ln.startswith("sample")]
    assert sample and sample[0] in text2.splitlines()
    assert rep2["tp"] == 2 and rep1["tp"] == 1
    assert rep2["decode_route"] == "paged_decode_sharded"
    assert "tp: 2 ranks," in text2
    assert "tp: 2 ranks over gloo, every rank's tokens equal rank 0's" \
        in text2
    assert rep2["gen_tokens"] == rep1["gen_tokens"]


ENGINE_SMALL = ("--engine", "--requests", "3", "--prompt-len", "10", "--gen",
                "5", "--page-size", "8", "--prefill-chunk", "8",
                "--max-batch", "2")


def test_front_end_serves_with_a_tuned_db(tmp_path):
    """`--engine --tuned-db` at reduced size: the DB's fastest engine point
    (page size 8, S_max kept) is applied and printed, the engine takes the
    DB (its linears' plans say "tuned"), and the front end closes it
    again."""
    from repro_torch.core import exec_plan
    from repro_torch.runtime import tuner
    db = str(tmp_path / "tuned.json")

    def measure(cfg, reps):
        slow = cfg["knobs"].get("page_size") == 16
        return {"us": 2.0 if slow else 1.0, "reps": reps, "spread": 0.0}

    tuner.run_sweep(db, smoke=True, ops=[tuner.ENGINE_OP, "matmul"],
                    policies=[tuner.ENGINE_POLICY, "w4a8_kv4_attn8"],
                    measure=measure)
    flags = list(ENGINE_SMALL)
    flags[flags.index("--page-size") + 1] = "16"
    rep, text = _main(*flags, "--policy", "w4a8_kv4_attn8", "--tuned-db", db)
    assert f"tuned engine knobs from {db}: {{'page_size': 8, 'spec_k': 0}}" \
        in text
    assert rep["n_requests"] == 3 and rep["tuned_db"] == db
    assert all(p["selection"] == "tuned"
               for p in rep["linear_plans"].values())
    assert exec_plan.tuned_db() is None


@pytest.mark.parametrize("flags,line", [
    (("--spec-draft", "w4a4_kv4_attn4"), "spec: draft k=4 under "
                                         "w4a4_kv4_attn4"),
    (("--spec-draft", "kv4_attn8_packed", "--spec-k", "3"),
     "spec: draft k=3 under kv4_attn8_packed"),
    (("--adaptive-draft",), "adaptive: 3-rung ladder"),
    (("--adaptive-draft", "--spec-k", "2", "--temperature", "0.8",
      "--top-k", "50"), "rung 2: w16a16_kv4_attn16 (k=2)")])
def test_front_end_speculation_flags_run(flags, line):
    rep, text = _main(*ENGINE_SMALL, *flags)
    assert line in text, text
    assert rep["n_requests"] == 3 and rep["spec_rounds"] > 0
    if "--spec-k" not in flags or "kv4_attn8_packed" not in flags:
        return
    assert rep["acceptance_rate"] == 1.0          # a self-draft


def test_front_end_speculation_guards():
    with pytest.raises(SystemExit, match="replaces --spec-draft"):
        _main(*ENGINE_SMALL, "--adaptive-draft", "--spec-draft",
              "w4a4_kv4_attn4")
    # prompt 10 + gen 5 fit S_max 16 alone, not with a 4-token window
    with pytest.raises(SystemExit, match="draft window"):
        _main(*ENGINE_SMALL, "--max-pages-per-req", "2",
              "--spec-draft", "w4a4_kv4_attn4")


def test_front_end_guards_s_max():
    with pytest.raises(SystemExit, match="S_max"):
        _main("--engine", "--prompt-len", "200", "--gen", "100")
