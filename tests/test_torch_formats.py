"""The kernels' remaining trans-precision formats, on the CPU: the port's
plain versions against the JAX package, and the wrappers' format gates.

- The fused matmul's new activation formats: the pre-pass `dpa_act_quant`
  at E2M1 and fp16 against `jax.jit(quantize_blockwise)` at tolerance 0
  (jitted: the reference multiplies by f32(1/target) there, as the port
  does), and the plain fused product with E2M1 / fp16 activations over
  E4M3 weights against `jax.jit(ref.dpa_matmul_fused_ref)` at rtol 2e-5 /
  atol 2e-4 (packed E2M1 weights: tests/test_torch_fused_plan.py).
- Exhaustively, the arithmetic the kernels rest on: every E2M1 value is
  an E4M3 value (E2M1 activations travel as E4M3 bytes), and every
  product of E2M1 or fp16 with E2M1 or E4M3 is exact in f32.
- Paged decode under kv8_attn_f32, kv16_attn_f32, attn_fp16_dpa and over
  unpacked E2M1 KV against the reference's `jnp_gather` route.
- DPA flash at fp16 and E2M1 attention against the Pallas kernel in
  interpret mode within the route's 0.075.
- The wrappers take exactly the new formats and refuse the open ones
  (naming their ROADMAP item) before the kernel library loads;
  `kernel_formats` serves every preset the engine may run, the rungs of
  every default draft ladder among them.
- The slice as a whole on reduced qwen3-4b: `generate` under
  fp4_dpa_fused and the engine under the three paged presets token for
  token against the JAX package; the `use_flash` prefill under
  attn_fp16_dpa and attn_fp4_packed within the route's tol.

Measured on these inputs: the paged presets at most 4.8e-7 from
`jnp_gather` (the frameworks sum in other orders), DPA flash at most
9.0e-5 from the Pallas kernel, the prefill logits 4.9e-5.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.core.policy import (POLICIES,  # noqa: E402
                                     TransPrecisionPolicy, get_policy)
from repro_torch.core.quantize import decode_fp4  # noqa: E402
from repro_torch.distributed.step import make_prefill_step  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import dpa_matmul as DM  # noqa: E402
from repro_torch.kernels import flash_attention as TFA  # noqa: E402
from repro_torch.kernels import paged_decode as TPD  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import convert_params  # noqa: E402
from repro_torch.runtime.controller import (DEFAULT_LADDERS,  # noqa: E402
                                            default_ladder)

RQ = importlib.import_module("repro.core.quantize")
RREF = importlib.import_module("repro.kernels.ref")
RFA = importlib.import_module("repro.kernels.flash_attention")
RKV = importlib.import_module("repro.core.kvcache")
RPLAN = importlib.import_module("repro.core.exec_plan")
RPOL = importlib.import_module("repro.core.policy")
RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RENG = importlib.import_module("repro.launch.engine")
RSERVE = importlib.import_module("repro.launch.serve")
RSTEP = importlib.import_module("repro.distributed.step")

RTOL, ATOL = 2e-5, 2e-4          # the fused route's pin
DPA_ROUTE_TOL = 0.075            # the DPA flash route's (kernels/registry)
# the frameworks' sum orders: the reference pins its Pallas route to its
# own gather at 0, but the port's plain version and XLA's sum in other
# orders (measured up to 4.8e-7)
PAGED_TOL = 1e-6
NEW_X = ("fp4_e2m1", "fp16")
PAGED_PRESETS = ("kv8_attn_f32", "kv16_attn_f32", "attn_fp16_dpa")


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference under 32-bit JAX (`repro.core.dpa`, imported by
    other test files of a worker, turns x64 on)."""
    with jax.enable_x64(False):
        yield


# -----------------------------------------------------------------------------
# the fused matmul: E2M1 and fp16 activations
# -----------------------------------------------------------------------------

def _x(M, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x *= np.exp2(rng.integers(-6, 6, size=(M, 1))).astype(np.float32)
    x[1, 128:256] = 0                       # an all-zero K block
    x[2, :] = np.where(rng.random(K) < 0.5, -3.0, 3.0)   # every code at T
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", NEW_X)
def test_act_quant_matches_jax_blockwise_quantizer(fmt, dtype):
    x = torch.from_numpy(_x(16, 384, 3)).to(dtype)
    codes, scales = DM.dpa_act_quant_ref(x, fmt=fmt)
    want_q, want_s = jax.jit(functools.partial(
        RQ.quantize_blockwise, fmt=fmt, axis=-1, block=128))(
            jnp.asarray(x.float().numpy()))
    got_q = (codes.view(torch.float8_e4m3fn) if codes.dtype == torch.uint8
             else codes).float().numpy()
    np.testing.assert_array_equal(got_q,
                                  np.asarray(want_q).astype(np.float32))
    np.testing.assert_array_equal(
        scales.numpy().view(np.uint32),
        np.asarray(want_s)[..., 0].astype(np.float32).view(np.uint32))
    assert codes.dtype == (torch.float16 if fmt == "fp16" else torch.uint8)


@pytest.mark.parametrize("fmt_x", NEW_X)
def test_fused_plain_over_e4m3_weights_matches_jax(fmt_x):
    M, K, N = 11, 384, 96
    x = torch.from_numpy(_x(M, K, 4))
    rng = np.random.default_rng(5)
    w8 = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                          ).to(torch.float8_e4m3fn)
    sw = torch.from_numpy(rng.uniform(0.01, 0.1, (1, N)).astype(np.float32))
    got = DM.dpa_matmul_fused_ref(x, w8, sw, fmt_x=fmt_x, fmt_w="fp8_e4m3")
    want = jax.jit(functools.partial(
        RREF.dpa_matmul_fused_ref, fmt_x=fmt_x, fmt_w="fp8_e4m3", bk=128))(
            jnp.asarray(x.numpy()),
            jnp.asarray(w8.view(torch.uint8).numpy().view(jnp.float8_e4m3fn)),
            jnp.asarray(sw.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


# -----------------------------------------------------------------------------
# exhaustively: the values and products the kernels hold exactly
# -----------------------------------------------------------------------------

def _e2m1():
    return decode_fp4(torch.arange(16, dtype=torch.uint8)).numpy().astype(
        np.float64)


def _e4m3():
    v = torch.arange(256, dtype=torch.uint8).view(torch.float8_e4m3fn).float()
    return v[torch.isfinite(v)].numpy().astype(np.float64)


def _fp16():
    v = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    return v[np.isfinite(v)].astype(np.float64)            # 63,488 values


def test_every_e2m1_value_is_an_e4m3_value():
    """E2M1 activations travel as E4M3 bytes: the cast is exact, sign of
    zero included."""
    v = torch.from_numpy(_e2m1()).float()
    back = v.to(torch.float8_e4m3fn).float()
    assert torch.equal(back, v) and torch.equal(back.signbit(), v.signbit())


@pytest.mark.parametrize("a,b", [(_e2m1, _e2m1), (_e2m1, _e4m3),
                                 (_fp16, _e2m1), (_fp16, _e4m3)],
                         ids=["e2m1 x e2m1", "e2m1 x e4m3", "fp16 x e2m1",
                              "fp16 x e4m3"])
def test_every_product_is_exact_in_f32(a, b):
    """fp16 mma.sync multiplies exactly and adds in f32: each product of
    these operands (at most 11 + 4 significant bits, within 2^-33 ..
    2^24) is an f32 value."""
    x, y = a(), b()
    exact = np.multiply.outer(x, y)                     # exact in f64
    f32 = np.multiply.outer(x.astype(np.float32), y.astype(np.float32))
    np.testing.assert_array_equal(f32.astype(np.float64), exact)
    assert (x.astype(np.float16).astype(np.float64) == x).all()


# -----------------------------------------------------------------------------
# the wrappers' format gates
# -----------------------------------------------------------------------------

class _Loaded(Exception):
    """Raised where a launch would load the kernel library."""


@pytest.fixture
def no_library(monkeypatch):
    def load():
        raise _Loaded
    monkeypatch.setattr(build, "load_library", load)


@pytest.mark.parametrize("fmt_x,served", [
    ("fp8_e4m3", True), ("fp4_e2m1", True), ("fp16", True),
    ("bf16", False), ("fp8_e5m2", False), ("fp32", False)])
def test_fused_launch_takes_exactly_the_served_activations(no_library, fmt_x,
                                                           served):
    M, K, N = 8, 256, 128
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    wq = torch.zeros((K // 2, N), dtype=torch.uint8)
    sw = torch.ones((1, N))
    out = torch.empty((M, N))
    call = functools.partial(DM.launch_fused, x, wq, sw, out, 1, M, K, N,
                             fmt_x=fmt_x, fmt_w="fp4_e2m1", pack_w=True,
                             bk=DM.BK, what="test")
    if served:
        with pytest.raises(_Loaded):
            call()
    else:
        with pytest.raises(NotImplementedError,
                           match="Queue 2 under dpa_matmul_fused"):
            call()


@pytest.mark.parametrize("fmt,fmt_kv,served", [
    ("fp16", "fp16", True), ("fp4_e2m1", "fp4_e2m1", True),
    ("fp16", "fp4_e2m1", True), ("fp4_e2m1", "fp16", True),
    ("fp32", "fp8_e4m3", False), ("fp32", "fp16", False),
    ("bf16", "bf16", False), ("fp8_e4m3", "fp8_e5m2", False)])
def test_dpa_flash_takes_exactly_the_served_formats(fmt, fmt_kv, served):
    """Off the CPU a served pair reaches the launch (which refuses the meta
    device); an open one raises NotImplementedError naming its item."""
    q = torch.empty((1, 4, 128, 64), device="meta")
    k = torch.empty((1, 2, 128, 64), device="meta")
    call = functools.partial(TFA.dpa_flash_attention, q, k, k, fmt=fmt,
                             fmt_kv=fmt_kv)
    if served:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    else:
        with pytest.raises(NotImplementedError,
                           match="Queue 2 under dpa_flash_attention"):
            call()


def test_kernel_formats_serves_every_preset_and_default_ladder():
    """What the Engine checks at construction, with no card: the preset
    its own error message suggests (kv8_attn_f32), every kv-quantized
    preset, and every rung of the default draft ladder of each cache
    layout; a name that is no format is refused."""
    TPD.kernel_formats(*(getattr(get_policy("kv8_attn_f32"), a)
                         for a in ("fmt_attn", "fmt_kv", "kv_packed")))
    names = {n for n, p in POLICIES.items() if p.kv_quantized}
    for fmt_kv, packed in DEFAULT_LADDERS:
        serve = next(n for n in names if (get_policy(n).fmt_kv,
                                          get_policy(n).kv_packed)
                     == (fmt_kv, packed))
        names |= set(default_ladder(serve))
    assert {"kv8_attn_f32", "kv16_attn_f32", "attn_fp16_dpa"} <= names
    for name in sorted(names):
        pol = get_policy(name)
        kv, attn = TPD.kernel_formats(pol.fmt_attn, pol.fmt_kv, pol.kv_packed)
        assert (kv, attn) == (TPD._KERNEL_KV[pol.fmt_kv, pol.kv_packed],
                              TPD._KERNEL_ATTN[pol.fmt_attn]), name
    with pytest.raises(NotImplementedError, match="names no such pair"):
        TPD.kernel_formats("int8", "fp8_e4m3", False)


# -----------------------------------------------------------------------------
# paged decode and DPA flash: plain versions against the reference
# -----------------------------------------------------------------------------

PS, N_KV, HD, H = 8, 2, 64, 4
UNPACKED_FP4 = dict(fmt_attn="fp4_e2m1", fmt_kv="fp4_e2m1", kv_packed=False)


def _policies(preset):
    if preset == "unpacked fp4":
        return (TransPrecisionPolicy(**UNPACKED_FP4),
                RPOL.TransPrecisionPolicy(**UNPACKED_FP4))
    return get_policy(preset), RPOL.get_policy(preset)


@pytest.mark.parametrize("preset", PAGED_PRESETS + ("unpacked fp4",))
def test_paged_plain_matches_jnp_gather(preset):
    pol, rpol = _policies(preset)
    lengths = [13, 5, 17]
    B = len(lengths)
    S = max(-(-n // PS) for n in lengths) * PS
    rng = np.random.default_rng(21)
    k, v = (rng.standard_normal((B, S, N_KV, HD)).astype(np.float32)
            for _ in range(2))
    kw = dict(fmt=pol.fmt_kv, packed=pol.kv_packed)
    ref = RKV.paged_from_contiguous(jax.jit(
        lambda a, b: RKV.update_kv_cache(
            RKV.init_kv_cache(B, S, N_KV, HD, **kw), a, b, 0, **kw))(
                jnp.asarray(k), jnp.asarray(v)), lengths, page_size=PS)
    got = TKV.paged_from_contiguous(
        TKV.update_kv_cache(TKV.init_kv_cache(B, S, N_KV, HD, **kw),
                            torch.from_numpy(k), torch.from_numpy(v), 0,
                            **kw), lengths, page_size=PS)
    q = rng.standard_normal((B, 1, H, HD)).astype(np.float32)
    pos = np.asarray([n - 1 for n in lengths], np.int32)
    out = TPD.paged_decode_attention(
        torch.from_numpy(q), got["k_codes"], got["k_scale"], got["v_codes"],
        got["v_scale"], got["block_table"], torch.from_numpy(pos),
        fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, kv_packed=pol.kv_packed)
    entry = RPLAN.route("paged_decode", "jnp_gather")
    want = jax.jit(lambda a, c, p: entry.run(a, c, p, policy=rpol,
                                             scale=HD ** -0.5))(
        jnp.asarray(q), ref, jnp.asarray(pos))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=PAGED_TOL)
    assert TPD.kernel_formats(pol.fmt_attn, pol.fmt_kv, pol.kv_packed)


@pytest.mark.parametrize("fmt,fmt_kv", [("fp16", "fp16"),
                                        ("fp4_e2m1", "fp4_e2m1"),
                                        ("fp16", "fp4_e2m1")])
def test_dpa_flash_plain_matches_pallas(fmt, fmt_kv):
    rng = np.random.default_rng(len(fmt) + len(fmt_kv))
    q, k, v = (rng.standard_normal((1, h, 256, 64)).astype(np.float32)
               for h in (4, 2, 2))
    want = RFA.dpa_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), fmt=fmt,
        fmt_kv=fmt_kv, bq=128, bk=128, interpret=True)
    got = TFA.dpa_flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  fmt=fmt, fmt_kv=fmt_kv, bq=128, bk=128)
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= DPA_ROUTE_TOL, err


# -----------------------------------------------------------------------------
# the slice as a whole, reduced qwen3-4b
# -----------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _pair(policy, use_flash=False):
    kw = dict(policy=policy, use_flash=use_flash)
    rcfg = RCFG.reduce_config(RCFG.get_config("qwen3-4b")).replace(**kw)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config("qwen3-4b")).replace(**kw),
                         device="cpu")
    tparams = convert_params(jax.tree.map(np.asarray, rparams), tmodel)
    return rmodel, rparams, tmodel, tparams


def test_fp4_dpa_fused_generate_equals_jax():
    rmodel, rparams, tmodel, tparams = _pair("fp4_dpa_fused")
    prompt = np.random.default_rng(5).integers(
        0, tmodel.cfg.vocab_size, size=(2, 7)).astype(np.int32)
    got = generate(tmodel, tparams, prompt, 5, 12, device="cpu").numpy()
    want = np.asarray(RSERVE.generate(rmodel, rparams, jnp.asarray(prompt),
                                      5, 12))
    np.testing.assert_array_equal(got, want)


GEOM = dict(page_size=8, n_pages=24, max_batch=2, max_pages_per_req=3,
            token_budget=8, prefill_chunk=8)
LENS = [(9, 4), (14, 5), (5, 3)]


@pytest.mark.parametrize("preset", PAGED_PRESETS)
def test_engine_under_paged_preset_equals_jax_engine(preset):
    rmodel, rparams, tmodel, tparams = _pair(preset)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 256, size=s).astype(np.int32)
               for s, _ in LENS]
    reqs = [TE.Request(rid=i, prompt=p, max_new=g)
            for i, (p, (_, g)) in enumerate(zip(prompts, LENS))]
    rreqs = [RENG.Request(rid=i, prompt=p, max_new=g)
             for i, (p, (_, g)) in enumerate(zip(prompts, LENS))]
    engine = TE.Engine(tmodel, tparams, TE.EngineConfig(**GEOM),
                       device="cpu")
    rep = engine.run(reqs)
    RENG.Engine(rmodel, rparams, RENG.EngineConfig(**GEOM)).run(rreqs)
    for a, b in zip(reqs, rreqs):
        assert a.out_tokens == b.out_tokens, (preset, a.rid)
    assert rep["decode_route"] == "cuda_block_table"


@pytest.mark.parametrize("preset", ["attn_fp16_dpa", "attn_fp4_packed"])
def test_use_flash_prefill_within_the_route_tol(preset):
    rmodel, rparams, tmodel, tparams = _pair(preset, use_flash=True)
    toks = np.random.default_rng(6).integers(
        0, tmodel.cfg.vocab_size, size=(1, 256))
    want, _ = jax.jit(RSTEP.make_prefill_step(rmodel))(
        rparams, {"tokens": jnp.asarray(toks)})
    got, _ = make_prefill_step(tmodel)(tparams, torch.from_numpy(toks))
    err = float(np.abs(got.numpy() - np.asarray(want)).max())
    assert err <= DPA_ROUTE_TOL, err
