"""Reduced recurrentgemma-9b and xlstm-1.3b: the port's recurrent families
vs the JAX reference under `jax.jit`, on weights converted from the
reference's init and the same numpy tokens.

recurrentgemma: 4 layers (rg, rg, attn_local as one scan group, then a
tail rg), hd 16, window 8, MQA.  xlstm: 9 layers (7 mLSTM + 1 sLSTM as
one group, then a tail mLSTM), hd 16, chunk 8, no MLP.

  prefill, stepped decode  a 16-token prefill, then 12 decode steps (the
                           window slides), fp32 and w4a8_kv4_attn8, the
                           index as an int and as a 0-dim tensor: logits
                           within 1e-4 absolute (tests/test_torch_model.py's
                           pin), greedy tokens equal wherever the
                           reference's top-1/top-2 margin exceeds 2e-4,
                           and every layer's cache / recurrent state within
                           1e-4 of its largest magnitude after the last
                           step.  Under w4a8_kv4_attn8 a cross-framework
                           ulp can carry a value across an E4M3 / E2M1
                           rounding boundary, and one flipped code moves
                           the logits by ~1e-2, then rides the recurrent
                           state to the end: at most one step of a run
                           may pass the pin, by at most FLIP_TOL (greedy
                           tokens equal where the margin exceeds twice
                           that), and the port then resumes from the
                           reference's caches after that step.  On these
                           inputs recurrentgemma's step 2 flips (2.7e-2):
                           fed the same layer inputs and caches, its second
                           RG-LRU layer is the one block that differs;
                           inside it the gate coefficients differ by an
                           ulp (XLA's and ATen's exp / sigmoid), and its
                           `wo` fed the same input agrees bit for bit.
  generate                 the port's greedy tokens = JAX `generate`'s,
                           at every step up to the first where the
                           reference's margin is within twice the pin.
  use_flash prefill        reduced recurrentgemma: the DPA flash route's
                           plain version (hd 16, window 8) against the
                           reference's Pallas kernel in interpret mode:
                           logits within 1e-4 (the route's own tolerance
                           against the global-softmax route is 0.075).
  bit for bit              the window cache's prefill fill and decode
                           shift-and-append against the reference's
                           `apply_attention` on identical rows (rope off,
                           identity K/V projections); `conv1d` and its
                           state against the reference's `_conv1d`,
                           un-jitted (jitted XLA on the CPU contracts the
                           taps' multiply-adds into FMAs: within 4
                           roundings of sum |x_i w_i|).
  associative scan         against `jax.lax.associative_scan`: the same
                           combine tree, so bit for bit un-jitted; jitted
                           XLA contracts a2 b1 + b2 into an FMA, so the b
                           sums move by ulps (held at 2e-6 of max |b|),
                           the a products stay bit for bit.

Measured worst on these inputs, outside the flipped step: logits 1.1e-6
(recurrentgemma) and 2.7e-5 (xlstm fp32 decode: the mLSTM's C state;
1.0e-6 under w4a8_kv4_attn8); use_flash prefill 1.2e-7; jitted scan
4.8e-7 at S = 64 on unit-normal b.
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
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RLAYERS = importlib.import_module("repro.models.layers")
RSERVE = importlib.import_module("repro.launch.serve")

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b")
POLICIES = ("fp32", "w4a8_kv4_attn8")
TOL = 1e-4
FLIP_TOL = 0.05        # one flipped E4M3 / E2M1 code's move of the logits
B, S, STEPS = 2, 16, 12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the many small ops of these reduced models
    lose most of their time to thread hand-offs; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference in 32-bit JAX (`repro.core.dpa`, imported by another
    test module in the same process, turns x64 on at import)."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _pair(arch, policy, **kw):
    rcfg = RCFG.reduce_config(RCFG.get_config(arch)).replace(policy=policy,
                                                            **kw)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(
        policy=policy, **kw), device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


@functools.lru_cache(maxsize=None)
def _jit_decode(arch, policy):
    return jax.jit(_pair(arch, policy)[0].decode_step)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, size=shape)


def _check(got, want, tol=TOL):
    err = float(np.max(np.abs(got - want)))
    assert err <= tol, err
    top2 = np.sort(want, axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0]) > 2 * tol
    agree = np.argmax(got, -1) == np.argmax(want, -1)
    assert np.all(agree[decisive])
    return err


def _layer_caches(rc, P, n_layers):
    """The reference's stacked caches {"groups": {"p<i>": stacked},
    "tail": [...]} as a per-layer list in layer order (numpy leaves)."""
    out = [jax.tree.map(lambda a, g=g: np.array(a)[g],
                        rc["groups"][f"p{i}"])
           for g in range(n_layers // P) for i in range(P)]
    return out + [jax.tree.map(np.array, t) for t in rc["tail"]]


def _leaves(c):
    return [c[k] for k in sorted(c)] if isinstance(c, dict) else list(c)


def _port_caches(layer_caches, like):
    """Per-layer numpy caches -> the port's (dicts / tuples of tensors in
    the dtypes of `like`)."""
    def one(c, ref):
        if isinstance(c, dict):
            return {k: torch.from_numpy(np.array(c[k])).to(ref[k].dtype)
                    for k in c}
        return tuple(torch.from_numpy(np.array(a)).to(r.dtype)
                     for a, r in zip(c, ref))
    return [one(c, r) for c, r in zip(layer_caches, like)]


@functools.lru_cache(maxsize=None)
def _reference_run(arch, policy):
    """The reference's jitted prefill over S tokens, then STEPS decode
    steps: (prompt, step tokens, prefill logits, logits per step, the
    caches after each step as per-layer lists)."""
    rmodel, rparams, _, _ = _pair(arch, policy)
    prompt = _tokens((B, S), 0)
    steps = _tokens((B, STEPS), 1)
    first, rc = jax.jit(rmodel.prefill)(rparams,
                                        {"tokens": jnp.asarray(prompt)})
    P = len(RMODELS.transformer.family_pattern(rmodel.cfg))
    step, wants, caches = _jit_decode(arch, policy), [], []
    for t in range(STEPS):
        want, rc = step(rparams, {"tokens": jnp.asarray(steps[:, t:t + 1]),
                                  "index": jnp.int32(S + t)}, rc)
        wants.append(np.asarray(want))
        caches.append(_layer_caches(rc, P, rmodel.cfg.n_layers))
    return prompt, steps, np.asarray(first), wants, caches


CASES = [(a, p) for a in ARCHS for p in POLICIES]


@pytest.mark.parametrize("arch,policy", CASES)
def test_prefill_logits_match_jax(arch, policy):
    _, _, tmodel, tparams = _pair(arch, policy)
    prompt, _, first, _, _ = _reference_run(arch, policy)
    got, caches = tmodel.prefill(tparams, torch.from_numpy(prompt))
    assert got.dtype == torch.float32 and got.shape == (B, 1, 256)
    assert len(caches) == tmodel.cfg.n_layers
    _check(got.numpy(), first)


@pytest.mark.parametrize("index", ("int", "tensor"))
@pytest.mark.parametrize("arch,policy", CASES)
def test_stepped_decode_matches_jax(arch, policy, index):
    _, _, tmodel, tparams = _pair(arch, policy)
    prompt, steps, _, wants, ref_caches = _reference_run(arch, policy)
    _, caches = tmodel.prefill(tparams, torch.from_numpy(prompt))
    flipped = []
    for t, want in enumerate(wants):
        idx = S + t if index == "int" else torch.tensor(S + t,
                                                        dtype=torch.int32)
        got, caches = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(steps[:, t:t + 1]),
                      "index": idx}, caches)
        if policy != "fp32" and np.max(np.abs(got.numpy() - want)) > TOL:
            _check(got.numpy(), want, FLIP_TOL)
            flipped.append(t)
            caches = _port_caches(ref_caches[t], caches)
            continue
        _check(got.numpy(), want)
    assert len(flipped) <= 1, flipped
    if flipped:
        return
    for layer, (got, want) in enumerate(zip(caches, ref_caches[-1])):
        for g, w in zip(_leaves(got), _leaves(want)):
            scale = max(1.0, float(np.max(np.abs(w))))
            np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                       atol=TOL * scale,
                                       err_msg=f"layer {layer}")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    """Greedy `generate` (prompt 6 + 8 new, s_ctx 16: the window of 8
    slides) on both sides; the reference's margins come from its jitted
    decode_step along its own tokens."""
    policy = "w4a8_kv4_attn8"
    rmodel, rparams, tmodel, tparams = _pair(arch, policy)
    prompt, n_gen, s_ctx = _tokens((B, 6), 2), 8, 16
    want = np.asarray(RSERVE.generate(rmodel, rparams, jnp.asarray(prompt),
                                      n_gen, s_ctx))
    got = TSERVE.generate(tmodel, tparams, torch.from_numpy(prompt), n_gen,
                          s_ctx, device="cpu").numpy()
    assert got.shape == want.shape == (B, 6 + n_gen)
    step, rc = _jit_decode(arch, policy), rmodel.init_caches(B, s_ctx)
    for t in range(6 + n_gen - 1):
        logits, rc = step(rparams, {"tokens": jnp.asarray(want[:, t:t + 1]),
                                    "index": jnp.int32(t)}, rc)
        top2 = np.sort(np.asarray(logits)[:, -1], axis=-1)[:, -2:]
        if t + 1 >= 6 and np.any(top2[:, 1] - top2[:, 0] <= 2 * TOL):
            break                      # a near tie: the paths may part
        np.testing.assert_array_equal(got[:, t + 1], want[:, t + 1],
                                      err_msg=f"position {t + 1}")


def _routes(monkeypatch):
    """Record the name and window of every `flash_attn` route resolved."""
    seen, resolve = [], exec_plan.resolve

    def spy(op, policy=None, **ctx):
        entry = resolve(op, policy, **ctx)
        if op == "flash_attn":
            seen.append(entry.name)
        return entry
    monkeypatch.setattr(exec_plan, "resolve", spy)
    return seen


def test_use_flash_prefill_matches_pallas(monkeypatch):
    arch, policy = "recurrentgemma-9b", "w4a8_kv4_attn8"
    rmodel, rparams, tmodel, tparams = _pair(arch, policy, use_flash=True)
    prompt = _tokens((1, 32), 3)
    want, _ = jax.jit(rmodel.prefill)(rparams,
                                      {"tokens": jnp.asarray(prompt)})
    seen = _routes(monkeypatch)
    got, caches = tmodel.prefill(tparams, torch.from_numpy(prompt))
    assert seen == ["cuda_dpa_flash"]      # the one local attention layer
    _check(got.numpy(), np.asarray(want))
    assert caches[2]["k"].shape == (1, 8, 1, 16)      # the window kept


def _identity_kv(arch="recurrentgemma-9b"):
    """Reduced recurrentgemma with rope off and K/V projections that copy
    the input's first KV x hd features: k = v = x[..., :16] exactly."""
    rmodel, rparams, tmodel, tparams = _pair(arch, "fp32", rope_theta=0.0)
    cfg = tmodel.cfg
    eye = np.zeros((cfg.d_model, cfg.n_kv_heads * cfg.hd), np.float32)
    eye[np.arange(eye.shape[1]), np.arange(eye.shape[1])] = 1.0
    rattn = jax.tree.map(lambda a: a[0], rparams["stack"]["groups"]["p2"]
                         ["attn"])
    rattn = dict(rattn, wk={"w": jnp.asarray(eye)}, wv={"w": jnp.asarray(eye)})
    tattn = dict(tparams["layers"][2]["attn"], wk={"w": torch.from_numpy(eye)},
                 wv={"w": torch.from_numpy(eye)})
    return rmodel.cfg, rattn, cfg, tattn


@pytest.mark.parametrize("index", ("int", "tensor"))
def test_window_cache_bit_for_bit(index):
    rcfg, rattn, tcfg, tattn = _identity_kv()
    W = tcfg.window
    rng = np.random.default_rng(4)
    attn = jax.jit(functools.partial(RLAYERS.apply_attention, cfg=rcfg,
                                     window=W, cache_mode="window",
                                     use_rope=False))
    for s0 in (5, 12):                 # a prefill shorter, then longer, than W
        x = rng.standard_normal((B, s0, tcfg.d_model)).astype(np.float32)
        zeros = np.zeros((B, W, 1, tcfg.hd), np.float32)
        _, rc = attn(rattn, jnp.asarray(x), offset=0,
                     cache={"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)})
        tc = {"k": torch.zeros((B, W, 1, tcfg.hd)),
              "v": torch.zeros((B, W, 1, tcfg.hd))}
        TL.apply_attention(tattn, torch.from_numpy(x), tcfg, offset=0,
                           cache=tc, window=W, cache_mode="window")
        for key in ("k", "v"):
            np.testing.assert_array_equal(tc[key].numpy(), np.asarray(rc[key]))
        for t in range(s0, s0 + 12):
            xt = rng.standard_normal((B, 1, tcfg.d_model)).astype(np.float32)
            _, rc = attn(rattn, jnp.asarray(xt), offset=jnp.int32(t),
                         cache=rc)
            off = t if index == "int" else torch.tensor(t, dtype=torch.int32)
            TL.apply_attention(tattn, torch.from_numpy(xt), tcfg, offset=off,
                               cache=tc, window=W, cache_mode="window")
            for key in ("k", "v"):
                np.testing.assert_array_equal(tc[key].numpy(),
                                              np.asarray(rc[key]))


def test_window_valid_slots():
    for t in range(12):
        want = np.arange(8) >= 8 - min(t + 1, 8)
        assert np.array_equal(TL.window_valid(t, 8, "cpu").numpy(), want)
        got = TL.window_valid(torch.tensor(t, dtype=torch.int32), 8, "cpu")
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("with_state", (False, True))
def test_conv1d_bit_for_bit(dtype, with_state):
    rng = np.random.default_rng(5)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x = jnp.asarray(rng.standard_normal((B, 13, 32)), jdt)
    w = jnp.asarray(rng.standard_normal((4, 32)), jnp.float32)
    st = jnp.asarray(rng.standard_normal((B, 3, 32)), jdt) \
        if with_state else None
    want, want_st = RLAYERS._conv1d(x, w, st)
    jit_out, jit_st = jax.jit(RLAYERS._conv1d)(x, w, st)

    def t(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            a.dtype == jnp.bfloat16 and torch.bfloat16 or torch.float32)
    got, got_st = TL.conv1d(t(x), t(w), None if st is None else t(st))
    assert got.dtype == tdt and got_st.dtype == tdt
    for g, w_ in ((got, want), (got_st, want_st), (got_st, jit_st)):
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w_, np.float32))
    # the jitted sum's fused multiply-adds move it by a few roundings of
    # the terms' magnitudes
    xp = np.concatenate([np.zeros((B, 3, 32)) if st is None
                         else np.asarray(st, np.float32),
                         np.asarray(x, np.float32)], axis=1)
    mag = sum(np.abs(xp[:, i:i + 13] * np.asarray(w)[i]) for i in range(4))
    eps = 2.0 ** (-8 if dtype == "bfloat16" else -24)
    assert np.all(np.abs(got.float().numpy()
                         - np.asarray(jit_out, np.float32)) <= 4 * eps * mag)


def _comb(c1, c2):
    return (c1[0] * c2[0], c2[0] * c1[1] + c2[1])


@pytest.mark.parametrize("n", (1, 2, 5, 37, 64))
def test_associative_scan_matches_jax(n):
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (B, n, 8)).astype(np.float32)
    b = rng.standard_normal((B, n, 8)).astype(np.float32)
    ga, gb = TL.associative_scan(torch.from_numpy(a), torch.from_numpy(b))
    with jax.disable_jit():
        wa, wb = jax.lax.associative_scan(_comb, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    ja, jb = jax.jit(lambda a, b: jax.lax.associative_scan(
        _comb, (a, b), axis=1))(a, b)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ja))
    assert np.max(np.abs(gb.numpy() - np.asarray(jb))) <= \
        2e-6 * np.max(np.abs(np.asarray(jb)))


@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_layout(arch):
    """The port's own init: per layer the reference's block params (kinds
    in pattern order, shapes without the scan axis), untied unembed."""
    rmodel, rparams, _, tparams = _pair(arch, "fp32")
    cfg = reduce_config(get_config(arch)).replace(policy="fp32")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    conv = jax.tree.map(lambda a: tuple(a.shape), tparams)
    mine = jax.tree.map(lambda a: tuple(a.shape), params)
    assert mine == conv
    assert params["unembed"]["table"].shape == (256, cfg.d_model)
    assert not torch.equal(params["unembed"]["table"],
                           params["embed"]["table"])


FULL = ("recurrentgemma-9b", "xlstm-1.3b", "deepseek-67b", "qwen2-72b",
        "dbrx-132b", "whisper-medium", "pixtral-12b")


@pytest.mark.parametrize("arch", FULL)
def test_full_configs_build(arch):
    """The full-width configs build (no init) and equal the reference's
    field for field."""
    cfg = get_config(arch)
    model = build_model(cfg, device="cpu")
    assert len(model.kinds) == cfg.n_layers
    for f in RCFG.get_config(arch).__dataclass_fields__:
        assert getattr(cfg, f) == getattr(RCFG.get_config(arch), f), f


@pytest.mark.parametrize("arch", ("recurrentgemma-9b", "xlstm-1.3b",
                                  "qwen3-4b"))
def test_report_kv_cache_counts_attention_layers(arch):
    cfg = get_config(arch).replace(policy="w4a8_kv4_attn8")
    assert TSERVE.report_kv_cache(cfg, 2, 48) == \
        RSERVE.report_kv_cache(RCFG.get_config(arch).replace(
            policy="w4a8_kv4_attn8"), 2, 48)


def test_engine_refuses_patterned_stacks():
    from repro_torch.launch.engine import Engine, EngineConfig
    _, _, tmodel, tparams = _pair("recurrentgemma-9b", "w4a8_kv4_attn8")
    with pytest.raises(ValueError, match="uniform-attention"):
        Engine(tmodel, tparams, EngineConfig(page_size=8, n_pages=16,
                                             max_batch=2,
                                             max_pages_per_req=4,
                                             token_budget=16,
                                             prefill_chunk=8),
               device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_front_end(arch, capsys):
    out = TSERVE.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--policy", "w4a8_kv4_attn8", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4"])
    text = capsys.readouterr().out
    assert tuple(out.shape) == (2, 12)
    assert "kv-cache:" in text and "generated (2, 12)" in text


HOST_READS = ("item", "__int__", "__index__", "__bool__", "__float__",
              "tolist", "cpu", "numpy")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_makes_no_host_sync(monkeypatch, arch):
    """The serve step `generate` captures as a CUDA graph reads nothing
    back to the host: the window cache's valid slots, the shift and the
    recurrent states' updates stay on the device (Tensor reads patched to
    raise)."""
    from repro_torch.distributed.step import make_serve_step
    _, _, tmodel, tparams = _pair(arch, "w4a8_kv4_attn8")
    caches = tmodel.init_caches(B, 16)
    batch = {"tokens": torch.zeros((B, 1), dtype=torch.int64),
             "index": torch.tensor(11, dtype=torch.int32)}
    step = make_serve_step(tmodel)

    def raiser(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"host sync inside the step: Tensor.{name}")
        return read
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, raiser(name))
    nxt, _ = step(tparams, batch, caches)
    monkeypatch.undo()
    assert nxt.shape == (B,) and nxt.dtype == torch.int32


def test_hd256_flash_wrappers():
    """Head dim 256 off the CPU: the f32 flash kernel has no instance and
    raises NotImplementedError naming its ROADMAP item before it loads
    anything; the DPA kernel serves it with q blocks of at most 64 rows
    (its launch then refuses a non-CUDA device)."""
    from repro_torch.kernels import flash_attention as TFA
    q = torch.empty((1, 16, 128, 256), device="meta")
    k = torch.empty((1, 1, 128, 256), device="meta")
    with pytest.raises(NotImplementedError, match="f32 flash kernel"):
        TFA.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="unsupported device"):
        TFA.dpa_flash_attention(q, k, k, fmt="fp8_e4m3", fmt_kv="fp4_e2m1",
                                bq=64)
    assert [TFA.max_bq(d) for d in (64, 128, 256)] == [128, 128, 64]
