"""Reduced whisper-medium (the encoder-decoder) and pixtral-12b (the VLM):
the port against the JAX reference under `jax.jit`, on weights converted
from the reference's init and the same numpy inputs.

whisper: 2 encoder + 2 decoder layers, LayerNorm, GELU MLP with biases,
learned decoder positions, no rope, cross-attention over 24 stub frames.
pixtral: 2 layers over 16 stub embeddings (rope, RMSNorm, SwiGLU).

  train_logits          B 2 x S 16, under fp32, fp8_dpa and
                        w4a8_kv4_attn8, use_flash off and on: logits
                        within 1e-5 at fp32 and 1e-4 under the quantized
                        policies (tests/test_torch_model.py's pin).  The
                        kernel routes' own tolerances in
                        kernels/registry.py (0.35 for the fused matmul
                        against fake-quant, 0.075 for DPA flash against
                        the global-max route) are far looser: on the CPU
                        both sides run plain versions of the same
                        contracts, which agree to ulps.
  prefill, decode       prefill, then STEPS greedy-free decode steps on
                        given tokens from the prefill's caches grown to S
                        + STEPS positions (both sides' caches padded the
                        same way), the index an int and a 0-dim tensor;
                        whisper's steps take the reference's `encode`
                        output.  Same pins.
  encode                whisper's encoder alone, same pins.
  GELU experts          apply_moe's GELU branch: reduced granite-moe-1b
                        with act "gelu", fp32 and fp8_dpa, same pins.
  code flips            an E4M3 activation code that flips between XLA
                        and ATen would move the logits by ~1e-2; on these
                        inputs none does, so every case above holds its
                        pin.  The transcendental that parts most is GELU's
                        tanh: XLA's and ATen's differ in the last bits of
                        many outputs, by at most GELU_ABS, and
                        `test_gelu_tanh_flips_named_codes` counts the E4M3
                        codes that flips on its own input (one of 8,192).
                        The stub front ends' erf_inv is below.
  flash kernels         non-causal attention at Sk = 250 (the reference's
                        `_fit_block(128, 250)` = 125 keys a block) and Sq
                        250 or 50 (cross-attention): the port's plain
                        versions against the Pallas kernels in interpret
                        mode, at the blocks the routes pick.
  stub batches          the pipeline's frames / embeddings: uniforms bit
                        for bit, normals within NORMAL_ULPS ulp (XLA's
                        erf_inv polynomial, ATen's log1p inside it).
  train                 one train step of each family against the
                        reference's jitted `make_train_step` on its
                        pipeline's stub batch (fp32 and fp8_dpa: loss rtol
                        1e-4 / 1e-3, leaves at relative norm 1e-3 /
                        1e-2, as tests/test_torch_train_steps.py), and
                        `launch.train.main --reduced --device cpu`;
                        only the VLM's token table may miss the loss.
  layout                the port's own init, the decay mask, the
                        learned-position clamp, the front end's and the
                        engine's refusals, the card as every entry
                        point's default device.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.quantize import fake_quant  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.distributed import step as TS  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels.registry import _fit_block  # noqa: E402
from repro_torch.launch import serve as TSERVE  # noqa: E402
from repro_torch.launch import train as TTRAIN  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models.convert import convert_params, convert_tree  # noqa
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serving import threefry as TF  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")
RADAMW = importlib.import_module("repro.optim.adamw")
RDATA = importlib.import_module("repro.data.pipeline")
RKOPS = importlib.import_module("repro.kernels.flash_attention")

ARCHS = ("whisper-medium", "pixtral-12b")
POLICIES = ("fp32", "fp8_dpa", "w4a8_kv4_attn8")
B, S, SE, STEPS = 2, 16, 24, 6
F32_TOL = 1e-5
TOL = 1e-4
NORMAL_ULPS = 4
GELU_ABS = 1e-6        # XLA's tanh GELU vs ATen's, absolute
GELU_FLIPS = 1         # E4M3 codes the difference flips on its test input
TRAIN_TOL = {"fp32": dict(loss=1e-4, leaf=1e-3),
             "fp8_dpa": dict(loss=1e-3, leaf=1e-2)}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)


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
def _pair(arch, policy, use_flash=False):
    kw = dict(policy=policy, use_flash=use_flash)
    rmodel = RMODELS.build_model(
        RCFG.reduce_config(RCFG.get_config(arch)).replace(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(**kw),
                         device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def _inputs(arch):
    """The numpy batch (frames and tokens, or embeddings) and the decode
    steps' tokens."""
    rng = np.random.default_rng(0)
    steps = rng.integers(0, 256, (B, STEPS))
    if arch == "whisper-medium":
        return {"frames": rng.standard_normal((B, SE, 64)).astype(
            np.float32), "tokens": rng.integers(0, 256, (B, S))}, steps
    return {"embeddings": rng.standard_normal((B, S, 64)).astype(
        np.float32)}, steps


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _pad_jax(caches, n):
    return jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, n)] + [(0, 0)] *
                          (a.ndim - 3)), caches)


def _pad_port(caches, n):
    return [{k: torch.nn.functional.pad(
        v, (0, 0) * (v.ndim - 2) + (0, n)) for k, v in c.items()}
        for c in caches]


@functools.lru_cache(maxsize=None)
def _reference(arch, policy, use_flash):
    """The reference's jitted train_logits, encode (whisper), prefill and
    STEPS decode steps from the prefill's caches padded to S + STEPS."""
    rmodel, rparams, _, _ = _pair(arch, policy, use_flash)
    batch, steps = _inputs(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"train": np.asarray(jax.jit(rmodel.train_logits)(rparams, jb)[0])}
    extra = {}
    if arch == "whisper-medium":
        enc = jax.jit(rmodel.encode)(rparams, jb["frames"])
        out["encode"] = np.asarray(enc)
        extra = {"enc_out": enc}
    first, rc = jax.jit(rmodel.prefill)(rparams, jb)
    out["prefill"] = np.asarray(first)
    rc = _pad_jax(rc, STEPS)
    step, dec = jax.jit(rmodel.decode_step), []
    for t in range(STEPS):
        logits, rc = step(rparams, {"tokens": jnp.asarray(steps[:, t:t + 1]),
                                    "index": jnp.int32(S + t), **extra}, rc)
        dec.append(np.asarray(logits))
    out["decode"] = np.stack(dec)
    return out


def _check(policy, what, got, want):
    """got within the policy's pin of want."""
    err = float(np.max(np.abs(got - want)))
    assert err <= (F32_TOL if policy == "fp32" else TOL), (what, err)


CASES = [(a, p, f) for a in ARCHS for p in POLICIES for f in (False, True)]


@pytest.mark.parametrize("arch,policy,use_flash", CASES)
def test_train_logits_match_jax(arch, policy, use_flash):
    _, _, tmodel, tparams = _pair(arch, policy, use_flash)
    batch, _ = _inputs(arch)
    got, aux = tmodel.train_logits(tparams, _torch(batch))
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    assert float(aux) == 0.0
    _check(policy, "train", got.detach().numpy(),
           _reference(arch, policy, use_flash)["train"])


@pytest.mark.parametrize("index", ("int", "tensor"))
@pytest.mark.parametrize("arch,policy,use_flash", CASES)
def test_prefill_then_decode_match_jax(arch, policy, use_flash, index):
    _, _, tmodel, tparams = _pair(arch, policy, use_flash)
    batch, steps = _inputs(arch)
    want = _reference(arch, policy, use_flash)
    first, caches = tmodel.prefill(tparams, _torch(batch))
    assert first.shape == (B, 1, 256) and len(caches) == tmodel.cfg.n_layers
    _check(policy, "prefill", first.numpy(), want["prefill"])
    extra = ({"enc_out": torch.from_numpy(np.array(want["encode"]))}
             if arch == "whisper-medium" else {})
    caches = _pad_port(caches, STEPS)
    got = []
    for t in range(STEPS):
        idx = S + t if index == "int" else torch.tensor(S + t,
                                                        dtype=torch.int32)
        logits, caches = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(steps[:, t:t + 1]),
                      "index": idx, **extra}, caches)
        got.append(logits.numpy())
    _check(policy, "decode", np.stack(got), want["decode"])


@pytest.mark.parametrize("policy,use_flash",
                         [(p, f) for p in POLICIES for f in (False, True)])
def test_encode_matches_jax(policy, use_flash):
    arch = "whisper-medium"
    _, _, tmodel, tparams = _pair(arch, policy, use_flash)
    batch, _ = _inputs(arch)
    got = tmodel.encode(tparams, torch.from_numpy(batch["frames"]))
    assert got.shape == (B, SE, 64)
    _check(policy, "encode", got.detach().numpy(),
           _reference(arch, policy, use_flash)["encode"])


@pytest.mark.parametrize("policy", ("fp32", "fp8_dpa"))
def test_gelu_experts_match_jax(policy):
    """apply_moe's GELU branch (2 expert stacks, no wg): reduced
    granite-moe-1b with act "gelu", train_logits against the reference."""
    kw = dict(policy=policy, act="gelu")
    rmodel = RMODELS.build_model(RCFG.reduce_config(RCFG.get_config(
        "granite-moe-1b-a400m")).replace(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(
        "granite-moe-1b-a400m")).replace(**kw), device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    assert set(tparams["layers"][0]["mlp"]) == {"router", "wu", "wd"}
    tokens = np.random.default_rng(4).integers(0, 256, (B, S))
    want, waux = jax.jit(rmodel.train_logits)(rparams,
                                              {"tokens": jnp.asarray(tokens)})
    got, aux = tmodel.train_logits(tparams,
                                   {"tokens": torch.from_numpy(tokens)})
    _check(policy, "train", got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(float(aux), float(waux), rtol=1e-6)


# -----------------------------------------------------------------------------
# GELU's tanh: where XLA and ATen part
# -----------------------------------------------------------------------------

def test_gelu_tanh_flips_named_codes():
    """jax.nn.gelu (tanh form) under jit against `layers.gelu` on the
    same f32 inputs (unit-scale outputs up to ~12): XLA's tanh is a
    rational approximation clamped to +-1 past |z| ~ 7.9, ATen's is not,
    so the far negative tail is -0.0 on one side and ~-5e-7 on the other,
    and elsewhere the last bits differ.  Within GELU_ABS everywhere;
    fake-quantized onto E4M3 per tensor (fp8_dpa's activations) exactly
    GELU_FLIPS codes flip on these 8,192 inputs."""
    x = np.random.default_rng(3).standard_normal((64, 128)).astype(
        np.float32) * 3
    want = np.asarray(jax.jit(jax.nn.gelu)(x))
    got = TL.gelu(torch.from_numpy(x)).numpy()
    assert float(np.abs(got - want).max()) <= GELU_ABS
    differ = int((got != want).sum())
    q = [fake_quant(torch.from_numpy(np.array(a)), "fp8_e4m3").numpy()
         for a in (got, want)]
    flipped = int((q[0] != q[1]).sum())
    print(f"gelu: {differ} of {x.size} outputs differ; {flipped} E4M3 "
          "codes flip")
    assert differ > 0 and flipped == GELU_FLIPS


# -----------------------------------------------------------------------------
# flash: non-causal, Sq != Sk, 125-key blocks
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("sq", (250, 50))
@pytest.mark.parametrize("kernel", ("f32", "dpa"))
def test_noncausal_flash_matches_pallas(kernel, sq):
    """The plain versions against the Pallas kernels (interpret mode) at
    Sk = 250, not causal: the reference's blocks are bq =
    _fit_block(128, Sq), bk = _fit_block(128, 250) = 125, and the DPA
    kernel quantizes p per (row, 125-key block)."""
    rng = np.random.default_rng(11)
    H, KV, sk, hd = 4, 2, 250, 16
    q = rng.standard_normal((1, H, sq, hd)).astype(np.float32)
    k = rng.standard_normal((1, KV, sk, hd)).astype(np.float32)
    v = rng.standard_normal((1, KV, sk, hd)).astype(np.float32)
    bq, bk = _fit_block(128, sq), _fit_block(128, sk)
    assert bk == 125
    t = [torch.from_numpy(a) for a in (q, k, v)]
    if kernel == "f32":
        want = RKOPS.flash_attention(q, k, v, causal=False, bq=bq, bk=bk,
                                     interpret=True)
        got = TFA.flash_attention(*t, causal=False, bq=bq, bk=bk)
        tol = 2e-6
    else:
        kw = dict(fmt="fp8_e4m3", fmt_kv="fp4_e2m1", causal=False)
        want = RKOPS.dpa_flash_attention(q, k, v, bq=bq, bk=bk,
                                         interpret=True, **kw)
        got = TFA.dpa_flash_attention(*t, bq=bq, bk=bk, **kw)
        tol = 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=tol)


# -----------------------------------------------------------------------------
# the stub front ends' draws
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ((2, 16, 64), (1, 300, 128), (3, 7)))
def test_normal_matches_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 3)
    tkey = TF.fold_in(TF.prng_key(5), 3)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    n = int(np.prod(shape))
    assert np.array_equal(
        TF.uniform(tkey, n, lo, 1.0).numpy().reshape(shape),
        np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0)))
    want = np.asarray(jax.random.normal(key, shape, jnp.float32))
    got = TF.normal(tkey, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.all(np.abs(got - want) <= NORMAL_ULPS * np.spacing(
        np.abs(want)))


def _data_cfg(cfg, seq=12, **kw):
    """`launch.train`'s data config for the family (16 frames for the
    encoder-decoder)."""
    return dict(vocab_size=cfg.vocab_size, batch=2, seq=seq,
                frontend=cfg.frontend, d_model=cfg.d_model,
                frames=16 if cfg.family == "encdec" else 0, **kw)


@pytest.mark.parametrize("source", ("synthetic", "memmap"))
@pytest.mark.parametrize("arch", ARCHS)
def test_stub_batches_match_jax(arch, source, tmp_path):
    """`launch.train`'s data config for each family: the port's batches
    against the reference's, token and label ids equal, the frames or
    embeddings within NORMAL_ULPS ulp."""
    cfg = reduce_config(get_config(arch))
    kw = {}
    if source == "memmap":
        path = tmp_path / "tokens.bin"
        np.random.default_rng(0).integers(0, 256, 4096).astype(
            np.uint16).tofile(path)
        kw = dict(kind="memmap", path=str(path))
    for step in (0, 7):
        want = RDATA.make_pipeline(RDATA.DataConfig(
            **_data_cfg(cfg, **kw))).batch(step)
        got = TP.make_pipeline(TP.DataConfig(**_data_cfg(cfg, **kw)),
                               "cpu").batch(step)
        assert set(got) == set(want)
        assert ("frames" in got) == (arch == "whisper-medium")
        assert ("tokens" in got) == (arch == "whisper-medium")
        for name, w in want.items():
            g, w = got[name].numpy(), np.asarray(w)
            assert g.shape == w.shape, name
            if w.dtype == np.float32:
                assert np.all(np.abs(g - w) <= NORMAL_ULPS * np.spacing(
                    np.abs(w))), name
            else:
                assert np.array_equal(g, w), name


# -----------------------------------------------------------------------------
# training
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("policy", list(TRAIN_TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, policy):
    """One train step from one converted state on the reference
    pipeline's stub batch (`launch.train`'s data config), 8-token
    cross-entropy chunks: the loss and every updated leaf."""
    kw = dict(policy=policy, logits_chunk=8)
    rmodel = RMODELS.build_model(
        RCFG.reduce_config(RCFG.get_config(arch)).replace(**kw))
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(**kw),
                         device="cpu")
    rstep = jax.jit(RSTEP.make_train_step(rmodel, RADAMW.AdamWConfig(**OPT)))
    jb = RDATA.make_pipeline(RDATA.DataConfig(
        **_data_cfg(tmodel.cfg, seq=16))).batch(0)
    tb = {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if np.asarray(v).dtype.kind == "i" else torch.float32)
        for k, v in jb.items()}
    rstate, rm = rstep({"params": rparams, "opt": RADAMW.init(rparams)}, jb)
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    tstate, tm = TS.make_train_step(tmodel, adamw.AdamWConfig(**OPT))(
        {"params": tparams, "opt": adamw.init(tparams)}, tb)
    tol = TRAIN_TOL[policy]
    np.testing.assert_allclose(float(tm["loss"]), float(rm["loss"]),
                               rtol=tol["loss"])
    want = convert_tree(jax.tree.map(np.asarray, rstate["params"]), tmodel)
    errs = {".".join(p): float((a.detach() - b).norm()
                               / max(float(b.norm()), 1e-30))
            for (p, a), (_, b) in zip(flatten_with_paths(tstate["params"]),
                                      flatten_with_paths(want))}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= tol["leaf"], (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_each_family(arch, tmp_path, capsys):
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    state = TTRAIN.main(argv)
    out = capsys.readouterr().out
    losses = [float(ln.split()[3]) for ln in out.splitlines()
              if ln.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "done: 2 steps" in out and int(state["opt"]["count"]) == 2


@pytest.mark.parametrize("batch", ("embeddings", "tokens"))
def test_only_the_stub_table_may_miss_the_loss(batch):
    """`value_and_grad` gives the token table zeros when the batch
    carries embeddings (the VLM's front end, as JAX does) and raises for
    it, or any other leaf, that does not reach the loss otherwise."""
    params = {"embed": {"table": torch.ones(4, 3)},
              "w": torch.full((3,), 2.0)}
    b = {batch: torch.ones(2, 3)}

    def loss_fn(p, bt):
        return (p["w"] * bt[batch]).sum(), {}
    vg = TS.value_and_grad(loss_fn)
    if batch == "tokens":
        with pytest.raises(RuntimeError, match="embed.table does not reach"):
            vg(params, b)
        return
    (total, _), grads = vg(params, b)
    assert float(total) == 12.0
    assert torch.equal(grads["embed"]["table"], torch.zeros(4, 3))
    assert torch.equal(grads["w"], torch.full((3,), 2.0))
    params["extra"] = torch.ones(2)
    with pytest.raises(RuntimeError, match="extra does not reach"):
        vg(params, b)


# -----------------------------------------------------------------------------
# layout, positions, refusals
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_port_init_matches_reference_layout(arch):
    """The port's own init has the converted params' structure and
    shapes (LayerNorm and MLP biases, cross-attention, learned positions
    included)."""
    _, _, _, tparams = _pair(arch, "fp32")
    params = build_model(reduce_config(get_config(arch)).replace(
        policy="fp32"), device="cpu").init(torch.Generator().manual_seed(0))
    shapes = [(p, tuple(t.shape)) for p, t in flatten_with_paths(params)]
    assert shapes == [(p, tuple(t.shape))
                      for p, t in flatten_with_paths(tparams)]
    names = {".".join(p) for p, _ in shapes}
    if arch == "whisper-medium":
        assert {"pos_dec", "enc_norm.bias", "dec_layers.0.cross.wk.w",
                "dec_layers.0.norm_cross.bias",
                "enc_layers.1.mlp.wd.b"} <= names
    else:
        assert "layers.0.mlp.wg.w" in names and "embed.table" in names


@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_follows_the_stacked_layout(arch):
    """The reference decays leaves of 2 dims and more in its layout: both
    of whisper's stacks are scanned whole, so every layer leaf decays
    (norm scales and biases too); pos_dec and the tables decay, the final
    norms do not."""
    rmodel, rparams, tmodel, tparams = _pair(arch, "fp32")
    flags = convert_tree(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim >= 2, np.float32), rparams),
        tmodel)
    want = [bool(t.flatten()[0]) for _, t in flatten_with_paths(flags)]
    got = [bool(f) for _, f in flatten_with_paths(
        tmodel.decay_mask(tparams))]
    assert got == want


@pytest.mark.parametrize("index", (3, 4095, 5000, -2))
def test_decoder_positions_clamp_like_the_reference(index):
    """A one-token decoder input takes pos_dec's row at the index, its
    start clamped to [0, max_seq - 1] as dynamic_slice_in_dim clamps it,
    for an int and a 0-dim tensor index."""
    rmodel, rparams, tmodel, tparams = _pair("whisper-medium", "fp32")
    enc = _reference("whisper-medium", "fp32", False)["encode"]
    tok = np.array([[5], [9]])
    want, _ = jax.jit(rmodel.decode_step)(
        rparams, {"tokens": jnp.asarray(tok), "index": jnp.int32(index),
                  "enc_out": jnp.asarray(enc)}, rmodel.init_caches(B, 8))
    for idx in (index, torch.tensor(index, dtype=torch.int32)):
        got, _ = tmodel.decode_step(
            tparams, {"tokens": torch.from_numpy(tok), "index": idx,
                      "enc_out": torch.from_numpy(np.array(enc))},
            tmodel.init_caches(B, 8))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_front_end_and_engine_refuse(arch):
    """The front end serves token-in / token-out models only, as the
    reference's does; the engine takes uniform-attention decoders."""
    from repro_torch.launch.engine import Engine, EngineConfig
    with pytest.raises(SystemExit, match="token-in/token-out"):
        TSERVE.main(["--arch", arch, "--reduced", "--device", "cpu"])
    _, _, tmodel, tparams = _pair(arch, "w4a8_kv4_attn8")
    if arch == "whisper-medium":
        with pytest.raises(ValueError):
            Engine(tmodel, tparams, EngineConfig(
                page_size=8, n_pages=16, max_batch=2, max_pages_per_req=4,
                token_budget=16, prefill_chunk=8), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_default_to_the_card(arch):
    """build_model, the stub pipeline and launch.train run on the card
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    cfg = reduce_config(get_config(arch))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.make_pipeline(TP.DataConfig(**_data_cfg(cfg)))
    with pytest.raises(RuntimeError, match="CUDA"):
        TTRAIN.main(["--arch", arch, "--reduced", "--steps", "1"])
