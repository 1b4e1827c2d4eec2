"""Self-speculative decoding in the port (`repro_torch.serving.spec_decode`,
the engine's `spec=`), against the JAX reference.

- `verify_attn`: row i of one S_q-token pass equals a single-token
  `paged_decode` at positions + i at tolerance 0, for the reference
  test's four policies (the batch fold gives every row the decode step's
  shapes); and the port's route against JAX's `dpa_paged_verify_attn` at
  `tests/test_torch_paged_decode.py`'s 1e-4 (the two frameworks sum in
  other orders).
- `make_accept_fn`: greedy bit for bit against JAX's; sampled (the
  port's threefry streams are the reference's) with equal n_accepted and
  tokens in every row whose reference margins exceed 8 ulp: each
  accept/reject decision's |u - min(p/q, 1)| and the residual draw's
  top-1 minus top-2 of gumbel + log(dist); an all-NaN target row
  degenerates to token 0 in both.
- the engine, on the reduced qwen3-4b at the reference tests' geometry
  (`tests/test_spec_decode.py`): for the three (draft, verify) policy
  pairs the greedy spec engine's tokens equal the port's plain engine and
  JAX's spec engine per request; a self-draft accepts every token; the
  allocator's invariants hold after every tick and at drain, with at
  least one rollback; sampled runs repeat and drain, and a sampled
  request alone equals the same request in the batch (self-draft);
  mismatched cache formats are refused and the draft window
  counts against S_max.
- `per_row` (the verify pass on the card): every matmul and grouped
  matmul route gives the one-call form's bits on CPU tensors, and runs
  its rows at the decode step's shape where the card once refused it.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.serving import sampler as TS  # noqa: E402
from repro_torch.serving import spec_decode as TSD  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RE = importlib.import_module("repro.launch.engine")
RKV = importlib.import_module("repro.core.kvcache")
RD = importlib.import_module("repro.models.decode_attn")
RS = importlib.import_module("repro.serving.sampler")
RSD = importlib.import_module("repro.serving.spec_decode")

VERIFY_POLICY = "kv4_attn8_packed"
GEOM = dict(page_size=8, n_pages=32, max_batch=3, max_pages_per_req=4,
            token_budget=16, prefill_chunk=8)
ECFG = TE.EngineConfig(**GEOM)
LENS = [(9, 5), (14, 7), (5, 4)]
K = 3
POLICY_PAIRS = [
    ("w4a4_kv4_attn4", "kv4_attn8_packed"),    # all-fp4 draft, fp4 cache
    ("attn_fp8_dpa", "kv8_attn_f32"),          # fp8 draft, fp8 cache
    ("attn_fp16_dpa", "kv16_attn_f32"),        # fp16 draft, fp16 cache
]
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.95, seed=7)
TOL = 1e-4                  # tests/test_torch_paged_decode.py's pin


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops lose
    most of their time to thread hand-offs when test workers share the
    cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


# -----------------------------------------------------------------------------
# verify_attn
# -----------------------------------------------------------------------------

def _caches(pol, lengths, ps=8, n_kv=2, hd=16, seed=3):
    B = len(lengths)
    S = max(-(-n // ps) for n in lengths) * ps
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, n_kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, n_kv, hd)).astype(np.float32)
    kw = dict(fmt=pol.fmt_kv, packed=pol.kv_packed)
    ref = RKV.paged_from_contiguous(
        RKV.update_kv_cache(RKV.init_kv_cache(B, S, n_kv, hd, **kw),
                            jnp.asarray(k), jnp.asarray(v), 0, **kw),
        lengths, page_size=ps)
    got = TKV.paged_from_contiguous(
        TKV.update_kv_cache(TKV.init_kv_cache(B, S, n_kv, hd, **kw),
                            torch.from_numpy(k), torch.from_numpy(v), 0,
                            **kw),
        lengths, page_size=ps)
    return ref, got


VERIFY_POLICIES = ["kv4_attn8_packed", "kv8_attn_f32", "attn_fp16_dpa",
                   "attn_fp4_packed"]


@pytest.mark.parametrize("pol_name", VERIFY_POLICIES)
def test_verify_attn_matches_stepped_paged_decode(pol_name):
    pol = get_policy(pol_name)
    lengths, sq, hd = [13, 17, 9], 3, 16
    ref, cache = _caches(pol, lengths)
    q = np.random.default_rng(5).standard_normal(
        (3, sq, 4, hd)).astype(np.float32)
    pos = np.asarray([n - sq for n in lengths], np.int32)
    tq, tpos = torch.from_numpy(q), torch.from_numpy(pos)
    verify = exec_plan.resolve("verify_attn", pol, sq=sq)
    assert verify.name == "cuda_block_table"      # its plain version here
    got = verify.run(tq, cache, tpos, policy=pol, scale=hd ** -0.5)
    decode = exec_plan.resolve("paged_decode", pol)
    for i in range(sq):
        want = decode.run(tq[:, i:i + 1], cache, tpos + i, policy=pol,
                          scale=hd ** -0.5)
        assert torch.equal(got[:, i:i + 1], want), (pol_name, i)
    # against the reference's verify attention (JAX sums in other orders)
    rwant = np.asarray(jax.jit(lambda q, c, p: RD.dpa_paged_verify_attn(
        q, c, p, fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv,
        kv_packed=pol.kv_packed, scale=hd ** -0.5))(
            jnp.asarray(q), ref, jnp.asarray(pos)))
    assert float(np.max(np.abs(got.numpy() - rwant))) <= TOL


def test_verify_attn_registered_and_refused_for_raw_caches():
    assert "verify_attn" in exec_plan.ops()
    d = exec_plan.describe("verify_attn", VERIFY_POLICY, sq=K + 1, batch=3,
                           page_size=8, max_pages=4, kv_heads=2, hd=16)
    assert d["route"] == "cuda_block_table" and d["bytes_moved"] > 0
    assert d["reference"] == "torch_gather"
    with pytest.raises(exec_plan.PlanError, match="kv_quantized"):
        exec_plan.resolve("verify_attn", "fp16_dpa", sq=2)


# -----------------------------------------------------------------------------
# the accept rule
# -----------------------------------------------------------------------------

def _accept_inputs(B=64, k=K, V=256, seed=0):
    """Draft logits, target logits near them for half the rows (so rows
    accept some drafts and reject others), drafts drawn from the draft
    logits' argmax or at random, rids and positions."""
    rng = np.random.default_rng(seed)
    dl = rng.standard_normal((B, k, V)).astype(np.float32) * 2
    tl = rng.standard_normal((B, k + 1, V)).astype(np.float32) * 2
    near = rng.random(B) < 0.5
    tl[near, :k] = dl[near] + 0.1 * rng.standard_normal(
        (near.sum(), k, V)).astype(np.float32)
    drafts = np.where(rng.random((B, k)) < 0.7, dl.argmax(-1),
                      rng.integers(0, V, (B, k))).astype(np.int32)
    rids = rng.integers(0, 1000, B).astype(np.int32)
    pos = rng.integers(0, 5000, B).astype(np.int32)
    return dl, tl, drafts, rids, pos


def _both(scfg_kw, k, dl, tl, drafts, rids, pos):
    rcfg, tcfg = RS.SamplerConfig(**scfg_kw), TS.SamplerConfig(**scfg_kw)
    q = None if rcfg.greedy else np.array(
        RS.sample_probs(jnp.asarray(dl), rcfg))
    remit, racc = jax.jit(RSD.make_accept_fn(rcfg, k))(
        jnp.asarray(drafts), None if q is None else jnp.asarray(q),
        jnp.asarray(tl), jnp.asarray(rids), jnp.asarray(pos))
    temit, tacc = TSD.make_accept_fn(tcfg, k)(
        torch.from_numpy(drafts), None if q is None else torch.from_numpy(q),
        torch.from_numpy(tl), torch.from_numpy(rids), torch.from_numpy(pos))
    return (np.asarray(remit), np.asarray(racc), temit.numpy(),
            tacc.numpy(), q)


def test_greedy_accept_equals_jax():
    dl, tl, drafts, rids, pos = _accept_inputs()
    tl[::5, 1:3] = tl[::5, :1]           # tied rows: argmax takes the first
    remit, racc, temit, tacc, _ = _both({}, K, dl, tl, drafts, rids, pos)
    assert np.array_equal(remit, temit) and np.array_equal(racc, tacc)
    assert temit.dtype == np.int32 and tacc.dtype == np.int32
    assert 0 < tacc.sum() < K * len(tacc)


def _margins(scfg_kw, k, q, tl, drafts, rids, pos, acc):
    """The reference's decision margins per row, in ulps: every accept or
    reject decision the row took, |u - min(p(d)/q(d), 1)| over the
    spacing of the ratio, and the residual draw's top-1 minus top-2 of
    gumbel + log(dist) over the spacing of the top-1."""
    cfg = RS.SamplerConfig(**scfg_kw)
    p = np.asarray(RS.sample_probs(jnp.asarray(tl), cfg))
    B = len(rids)
    tok_pos = pos[:, None] + 1 + np.arange(k)[None]
    u = np.stack([np.asarray(RS.accept_uniforms(jnp.asarray(rids),
                                                jnp.asarray(tok_pos[:, j]),
                                                cfg)) for j in range(k)], 1)
    b = np.arange(B)[:, None]
    ratio = np.minimum(p[b, np.arange(k)[None], drafts]
                       / np.maximum(q[b, np.arange(k)[None], drafts],
                                    np.float32(1e-38)), 1.0)
    dec = np.abs(u - ratio) / np.spacing(np.maximum(ratio, 1e-30))
    taken = np.arange(k)[None] <= acc[:, None]          # the decisions made
    m_acc = np.where(taken, dec, np.inf).min(1)
    p_at = p[np.arange(B), acc]
    q_pad = np.concatenate([q, p[:, k:]], axis=1)
    resid = np.maximum(p_at - q_pad[np.arange(B), acc], 0)
    z = resid.sum(-1, keepdims=True)
    dist = np.where(z > 0, resid / np.maximum(z, 1e-38), p_at)
    logp = np.where(dist > 0, np.log(np.maximum(dist, 1e-38)), -np.inf)
    m_res = np.empty(B)
    for i in range(B):
        key = RS.request_key(cfg.seed, int(rids[i]), int(pos[i]) + 1
                             + int(acc[i]), RS.ROLE_RESIDUAL)
        z_i = np.asarray(jax.random.gumbel(key, (p.shape[-1],))) + logp[i]
        top = np.sort(z_i)[-2:]
        m_res[i] = (top[1] - top[0]) / np.spacing(abs(top[1]))
    return np.minimum(m_acc, m_res)


@pytest.mark.parametrize("scfg_kw", [SAMPLED, dict(temperature=1.0, seed=3)],
                         ids=["top-k-top-p", "plain"])
def test_sampled_accept_equals_jax_where_the_margin_is_clear(scfg_kw):
    dl, tl, drafts, rids, pos = _accept_inputs(seed=1)
    remit, racc, temit, tacc, q = _both(scfg_kw, K, dl, tl, drafts, rids,
                                        pos)
    margin = _margins(scfg_kw, K, q, tl, drafts, rids, pos, racc)
    clear = margin > 8
    assert clear.mean() >= 0.9, margin
    assert np.array_equal(tacc[clear], racc[clear])
    assert np.array_equal(temit[clear], remit[clear])
    assert 0 < racc.sum() < K * len(racc)          # accepts and rejects


def test_accept_survives_all_nan_target_row():
    k, V = 2, 8
    rng = np.random.default_rng(0)
    tl = rng.standard_normal((2, k + 1, V)).astype(np.float32)
    tl[0] = np.nan
    dl = rng.standard_normal((2, k, V)).astype(np.float32)
    drafts = np.asarray([[3, 4], [2, 6]], np.int32)
    rids, pos = np.asarray([0, 1], np.int32), np.asarray([5, 9], np.int32)
    kw = dict(temperature=0.9, top_k=4, top_p=0.9, seed=13)
    for scfg_kw in (kw, {}):
        remit, racc, temit, tacc, _ = _both(scfg_kw, k, dl, tl, drafts,
                                            rids, pos)
        assert np.all((temit >= 0) & (temit < V))
        assert tacc[0] == 0 and temit[0, 0] == 0
        assert tacc[0] == racc[0] and temit[0, 0] == remit[0, 0]


# -----------------------------------------------------------------------------
# the engine
# -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _base():
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(
        policy=VERIFY_POLICY)
    rparams = RMODELS.build_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, jax.tree.map(np.asarray, rparams), rparams


@functools.lru_cache(maxsize=None)
def _port_model(policy):
    cfg = reduce_config(get_config("qwen3-4b")).replace(policy=policy)
    model = build_model(cfg, device="cpu")
    return model, convert_params(_base()[1], model)


def _requests(mod, vocab=256, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rid=i, prompt=rng.integers(0, vocab, size=s0)
                        .astype(np.int32), max_new=g)
            for i, (s0, g) in enumerate(LENS)]


def _outputs(engine):
    return {r.rid: list(r.out_tokens) for r in engine.finished}


@functools.lru_cache(maxsize=None)
def _plain(verify):
    model, params = _port_model(verify)
    engine = TE.Engine(model, params, ECFG, device="cpu")
    engine.run(_requests(TE))
    return _outputs(engine)


@functools.lru_cache(maxsize=None)
def _spec(draft, verify):
    model, params = _port_model(verify)
    engine = TE.Engine(model, params, ECFG, device="cpu",
                       spec=TSD.SpecConfig(draft, k=K))
    rep = engine.run(_requests(TE))
    return engine, rep


@functools.lru_cache(maxsize=None)
def _jax_spec(draft, verify):
    rcfg, _, rparams = _base()
    rmodel = RMODELS.build_model(rcfg.replace(policy=verify))
    engine = RE.Engine(rmodel, rparams, RE.EngineConfig(**GEOM),
                       spec=RSD.SpecConfig(draft, k=K))
    engine.run(_requests(RE))
    return _outputs(engine)


@pytest.mark.parametrize("draft,verify", POLICY_PAIRS,
                         ids=[f"{d}->{v}" for d, v in POLICY_PAIRS])
def test_spec_engine_greedy_matches_plain_and_jax(draft, verify):
    engine, rep = _spec(draft, verify)
    got = _outputs(engine)
    assert got == _plain(verify)
    assert got == _jax_spec(draft, verify)
    assert rep["n_requests"] == len(LENS)
    assert rep["spec_draft_policy"] == draft and rep["spec_k"] == K
    assert rep["draft_route"] == "cuda_block_table"
    assert rep["verify_route"] == "cuda_block_table"
    assert 0.0 <= rep["acceptance_rate"] <= 1.0
    assert 1.0 <= rep["eff_tokens_per_round"] <= K + 1
    assert rep["draft_steps"] == K * rep["spec_rounds"]
    assert rep["verify_steps"] == rep["spec_rounds"]
    assert "spec: draft k=3 under " + draft in TE.format_report(rep, verify)


def test_self_draft_accepts_every_token():
    engine, rep = _spec(VERIFY_POLICY, VERIFY_POLICY)
    assert rep["acceptance_rate"] == 1.0
    assert engine.drafted == engine.drafts_accepted > 0
    assert rep["eff_tokens_per_round"] > K * 0.5
    assert _outputs(engine) == _plain(VERIFY_POLICY)


def _check_alloc_invariants(engine):
    alloc = engine.alloc
    live = [r for r in engine.slots if r is not None]
    assert alloc.in_use == sum(len(r.pages) for r in live)
    assert alloc.reserved == sum(r.reserved_left for r in live)
    assert alloc.reserved <= alloc.n_free
    assert alloc.in_use + alloc.n_free == alloc.capacity - 1
    for r in live:
        row = engine._table[r.slot]
        if r.state == TE.DECODE:
            assert list(row[:len(r.pages)]) == r.pages
            assert np.all(row[len(r.pages):] == TKV.SCRATCH_PAGE)
        else:
            assert np.all(row == TKV.SCRATCH_PAGE)
    # the device table the steps read is the host table
    assert np.array_equal(engine._block_table.numpy(), engine._table) or \
        engine._tables_dirty


def test_spec_rollback_allocator_invariants():
    model, params = _port_model(VERIFY_POLICY)
    engine = TE.Engine(model, params, ECFG, device="cpu",
                       spec=TSD.SpecConfig("w4a4_kv4_attn4", k=K))
    rollbacks, free = [], engine.alloc.free

    def spy_free(pages, **kw):
        if kw.get("to_reserved"):
            rollbacks.append(list(pages))
        return free(pages, **kw)

    engine.alloc.free = spy_free
    for req in _requests(TE):
        engine.submit(req)
    now = 0.0
    while engine.waiting or any(engine.slots):
        engine.step(now)
        _check_alloc_invariants(engine)
        now += 1.0
    assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
    assert np.all(engine._table == TKV.SCRATCH_PAGE)
    assert rollbacks and all(p != TKV.SCRATCH_PAGE for pages in rollbacks
                             for p in pages)
    assert _outputs(engine) == _plain(VERIFY_POLICY)


def _sampled(draft, reqs):
    model, params = _port_model(VERIFY_POLICY)
    engine = TE.Engine(model, params, ECFG, device="cpu",
                       sampler=TS.SamplerConfig(**SAMPLED),
                       spec=TSD.SpecConfig(draft, k=K))
    engine.run(reqs)
    assert engine.alloc.in_use == 0 and engine.alloc.reserved == 0
    return _outputs(engine)


def test_sampled_spec_deterministic_and_drains():
    """Keyed streams only: reruns give the same tokens, every request its
    max_new, the allocator drained."""
    batch = _sampled("w4a4_kv4_attn4", _requests(TE))
    assert batch == _sampled("w4a4_kv4_attn4", _requests(TE))
    for (_, g), (rid, toks) in zip(LENS, sorted(batch.items())):
        assert len(toks) == g, rid


def test_sampled_request_alone_matches_mixed_batch():
    """A request's sampled tokens alone equal its tokens in the batch,
    with a draft whose rows are computed apart: the self-draft (the
    w4a4 draft quantizes its activations per tensor, over the batch, so
    its proposals, and with them the accept draws, depend on the other
    rows, in the reference as here)."""
    batch = _sampled(VERIFY_POLICY, _requests(TE))
    for req in _requests(TE):
        assert _sampled(VERIFY_POLICY, [req])[req.rid] == batch[req.rid], \
            req.rid


def test_mismatched_cache_formats_refused():
    model, params = _port_model(VERIFY_POLICY)
    with pytest.raises(ValueError, match="cache format"):
        TE.Engine(model, params, ECFG, device="cpu",
                  spec=TSD.SpecConfig("attn_fp8_dpa"))
    with pytest.raises(ValueError, match="raw f32 cache"):
        TSD.validate_policy_pair("fp16_dpa", VERIFY_POLICY)
    with pytest.raises(ValueError, match="k must be"):
        TSD.SpecConfig("w4a4_kv4_attn4", k=0)
    with pytest.raises(ValueError, match="not both"):
        from repro_torch.runtime.controller import ControllerConfig
        TE.Engine(model, params, ECFG, device="cpu",
                  spec=TSD.SpecConfig("w4a4_kv4_attn4"),
                  adaptive=ControllerConfig(("w4a4_kv4_attn4",)))


# every matmul / grouped_matmul route, a policy that resolves it
PER_ROW_ROUTES = [
    ("matmul", "torch_f32", "kv4_attn8_packed"),
    ("matmul", "torch_fake_quant", "w4a4_kv4_attn4"),
    ("matmul", "cuda_fused", "w4a8_kv4_attn8"),
    ("matmul", "cuda_prequant", "fp4_dpa_packed"),
    ("grouped_matmul", "torch_f32", "kv4_attn8_packed"),
    ("grouped_matmul", "torch_fake_quant", "w4a4_kv4_attn4"),
    ("grouped_matmul", "cuda_grouped_fused", "w4a8_kv4_attn8"),
    ("grouped_matmul", "cuda_grouped_prequant", "fp4_dpa_packed"),
]
GROUPED_EQ = "becd,edf->becf"


def _route_case(op, route, policy, B, S, d_in=96, d_out=40, E=4, seed=0):
    """(route entry, policy, x, lin, kw): bf16 x of B batch rows and S
    query rows ((B, S, d_in), or the MoE buffer (B, E, S, d_in) whose S
    capacity slots are the rows), a seeded f32 master weight, prepared
    for a kernel route."""
    from repro_torch.core.linear import prepare_grouped_linear, prepare_linear
    gen = torch.Generator().manual_seed(seed)
    pol = get_policy(policy)
    grouped = op == "grouped_matmul"
    shape = (E, d_in, d_out) if grouped else (d_in, d_out)
    lin = {"w": torch.randn(shape, generator=gen) * d_in ** -0.5}
    xs = (B, E, S, d_in) if grouped else (B, S, d_in)
    x = torch.randn(xs, generator=gen).to(torch.bfloat16)
    if route.startswith("cuda"):
        if grouped:
            prepare_grouped_linear(lin, pol)
        else:
            prepare_linear(lin, pol, torch.bfloat16)
    return (exec_plan.route(op, route), pol, x, lin,
            {"eq": GROUPED_EQ} if grouped else {})


@pytest.mark.parametrize("B,S", [(3, 4), (33, 4)],
                         ids=["12-rows", "132-rows"])
@pytest.mark.parametrize("op,route,policy", PER_ROW_ROUTES,
                         ids=[f"{o}-{r}" for o, r, _ in PER_ROW_ROUTES])
def test_per_row_route_equals_one_call(op, route, policy, B, S):
    """`per_row` (the verify pass on the card) on CPU tensors equals the
    one-call form bit for bit on every route: the slicing and the
    concatenation, and the activations quantized over the whole tensor
    first (the fake-quant policies' per-tensor scale spans every row).
    132 rows pass `TILED_MIN_M`, where the fused routes split too (into
    calls of whole query rows below it)."""
    entry, pol, x, lin, kw = _route_case(op, route, policy, B, S)
    one = entry.run(x, lin, pol, **kw)
    got = entry.run(x, lin, pol, per_row=True, **kw)
    assert got.dtype == one.dtype and got.shape == one.shape
    assert torch.equal(got, one)


def _recorded_rows(monkeypatch, route):
    """Patch the product a route runs to record the rows of each call."""
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import registry as KR
    calls = []
    if route in ("torch_f32", "torch_fake_quant"):
        mod, name = KR, "rowwise_dot"
    elif route == "cuda_fused":
        mod, name = kops._dm, "dpa_matmul_fused"
    else:
        mod, name = kops._dm, "dpa_matmul_prequant"
    fn = getattr(mod, name)

    def rec(a, *args, **kw):
        calls.append(a.numel() // a.shape[-1])
        return fn(a, *args, **kw)

    monkeypatch.setattr(mod, name, rec)
    return calls


# (policy, route, batch, query rows, calls of how many rows): what the
# card refused before this pass's rows were split (the f32, fake-quant and
# prequant routes, and the fused one from 128 rows: --max-batch 32 k 4)
VERIFY_CASES = [
    ("w4a8_kv4_attn8", "cuda_fused", 4, K + 1, [16]),
    ("w4a8_kv4_attn8", "cuda_fused", 32, 5, [96, 64]),
    ("kv4_attn8_packed", "torch_f32", 4, K + 1, [4] * (K + 1)),
    ("w4a4_kv4_attn4", "torch_fake_quant", 4, K + 1, [4] * (K + 1)),
    ("fp4_dpa_packed", "cuda_prequant", 4, K + 1, [8] * (K + 1)),
]


def test_verify_rows_guard(monkeypatch):
    """What the card once refused (`check_verify_rows`) is served, each
    row of a verify pass with the decode step's bits: the split-K route
    stays one call below `TILED_MIN_M` rows (its row bits do not depend
    on M), and from there takes whole query rows in calls that each stay
    below it; every other route, at any row count, runs one product a
    query row at the decode step's rows (the prequant kernel's padded to
    8); every row equals a decode step's call on that
    row alone, but under a per-tensor activation scale (the fake-quant
    policies), which spans the whole verify pass, as in the reference."""
    for policy, route, B, S, want in VERIFY_CASES:
        pol = get_policy(policy)
        assert exec_plan.resolve("matmul", pol, w_dtype="float32").name \
            == route
        entry, pol, x, lin, _ = _route_case("matmul", route, policy, B, S)
        with monkeypatch.context() as mp:
            calls = _recorded_rows(mp, route)
            got = entry.run(x, lin, pol, per_row=True)
        assert calls == want, (policy, B, S, calls)
        for i in range(S if route != "torch_fake_quant" else 0):
            step = entry.run(x[:, i:i + 1].contiguous(), lin, pol)
            assert torch.equal(got[:, i:i + 1], step), (policy, i)
    assert not hasattr(TE, "check_verify_rows")
    assert not hasattr(TE, "VERIFY_ROWS_ITEM")


def test_spec_window_counts_against_s_max():
    model, params = _port_model(VERIFY_POLICY)
    engine = TE.Engine(model, params, ECFG, device="cpu",
                       spec=TSD.SpecConfig("w4a4_kv4_attn4", k=K))
    big = TE.Request(rid=99, prompt=np.zeros(ECFG.s_max - K + 1, np.int32),
                     max_new=K - 1)
    with pytest.raises(ValueError, match="draft"):
        engine.submit(big)
    # the same request fits the plain engine
    TE.Engine(model, params, ECFG, device="cpu").submit(
        TE.Request(rid=99, prompt=np.zeros(ECFG.s_max - K + 1, np.int32),
                   max_new=K - 1))
