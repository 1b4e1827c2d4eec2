"""Grouped (per-expert) and prequant DPA matmuls: port vs the JAX reference.

The port's pipelines on CPU tensors run the kernels' plain versions over
load-time prepared weights; the reference is `jax.jit` of
`repro.kernels.ops`'s pipelines, whose Pallas kernels run in interpret
mode and re-quantize the weights per call.  Tolerances:

  grouped fused   rtol 2e-5 / atol 2e-4 — the reference's own pin between
                  its fused kernel and `ref.dpa_matmul_fused_ref` (same
                  grids and scales, f32 sums in another order).
  prequant        0: both operands are packed E2M1 codes, every product a
                  multiple of 1/4 with |p| <= 36, so each sum over K is
                  exact in f32 in any order, and the epilogue
                  `(acc * sx) * sw` is two rounded products on both sides.
  fake-quant      rtol 1e-5 / atol 1e-5 (the same grids, f32 sums in
                  another order).

Shapes cover K and N padding (K 64 -> 128, N 200 -> 256), per-expert M
padding (3 -> 8) and the prefill chunk's unpadded M = 11.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import exec_plan as TPLAN  # noqa: E402
from repro_torch.core.linear import dpa_grouped_dot  # noqa: E402
from repro_torch.kernels import dpa_grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import dpa_matmul as DM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402

ROPS = importlib.import_module("repro.kernels.ops")
RPOL = importlib.import_module("repro.core.policy")
RPLAN = importlib.import_module("repro.core.exec_plan")

FUSED = ["w4a8_kv4_attn8", "fp8_dpa_fused"]
RTOL, ATOL = 2e-5, 2e-4
EQ = "becd,edf->becf"


def _x(shape, rng):
    x = rng.standard_normal(shape).astype(np.float32)
    # per-row magnitudes spread over 2^-4 .. 2^3
    return x * np.exp2(rng.integers(-4, 4, size=shape[:-1] + (1,))
                       ).astype(np.float32)


def _w(E, K, N, rng):
    return (rng.standard_normal((E, K, N)) * K ** -0.5).astype(np.float32)


def _inputs(eq, E, M, K, N, seed):
    """x for `eq` with M rows per expert ("becd": B = 2, C = M // 2)."""
    rng = np.random.default_rng(seed)
    shape = (E, M, K) if eq == "gti,gio->gto" else (2, E, M // 2, K)
    return _x(shape, rng), _w(E, K, N, rng)


@functools.lru_cache(maxsize=None)
def _jax(fn, policy, eq=None):
    kw = {} if eq is None else {"eq": eq}
    return jax.jit(functools.partial(getattr(ROPS, fn), policy=policy, **kw))


@pytest.mark.parametrize("policy", FUSED)
@pytest.mark.parametrize("eq,M", [("gti,gio->gto", 3), ("gti,gio->gto", 11),
                                  ("becd,edf->becf", 8)])
@pytest.mark.parametrize("K,N", [(64, 200), (256, 128)])
def test_grouped_fused_pipeline_matches_jax(policy, eq, M, K, N):
    x, w = _inputs(eq, 3, M, K, N, seed=M * 1000 + K + N)
    want = np.asarray(_jax("dpa_grouped_fused_pipeline", policy, eq)(
        jnp.asarray(x), jnp.asarray(w)))
    prep = TOPS.prep_grouped_weights(torch.from_numpy(w), policy)
    got = TOPS.dpa_grouped_fused_pipeline(torch.from_numpy(x), prep, policy,
                                          eq=eq)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", FUSED)
def test_grouped_fused_expert_slices_equal_dense_plain(policy):
    """Each expert of the grouped plain version is the dense plain
    version on that expert's operands, bit for bit."""
    x, w = _inputs("gti,gio->gto", 4, 8, 256, 128, seed=21)
    prep = TOPS.prep_grouped_weights(torch.from_numpy(w), policy)
    pol = RPOL.get_policy(policy)
    kw = dict(fmt_x=pol.fmt_acts, fmt_w=pol.fmt_weights,
              pack_w=prep["pack_w"])
    xt = torch.from_numpy(x)
    full = GM.dpa_grouped_matmul_fused_ref(xt, prep["wq"], prep["sw"], **kw)
    for e in range(4):
        one = DM.dpa_matmul_fused_ref(xt[e], prep["wq"][e], prep["sw"][e],
                                      **kw)
        assert torch.equal(full[e], one), e


def _drop_rows(x, n_live):
    """Zero every row past `n_live` of each expert: capacity slots that no
    token filled (or whose assignment was dropped) hold zeros."""
    x = x.copy()
    for e, n in enumerate(n_live):
        x[e, n:] = 0
    return x


def test_capacity_dropped_rows_are_exact_zero():
    """Zero rows give exactly 0 through both grouped pipelines, and the
    live rows equal the same rows with no dropped neighbours."""
    x, w = _inputs("gti,gio->gto", 3, 11, 256, 128, seed=5)
    xd = _drop_rows(x, [11, 4, 0])
    for policy, fn in (("w4a8_kv4_attn8", TOPS.dpa_grouped_fused_pipeline),
                       ("fp4_dpa_packed", TOPS.dpa_grouped_prequant_pipeline)):
        prep = TOPS.prep_grouped_weights(torch.from_numpy(w), policy)
        got = fn(torch.from_numpy(xd), prep, policy, eq="gti,gio->gto")
        assert torch.equal(got[1, 4:], torch.zeros_like(got[1, 4:]))
        assert torch.equal(got[2], torch.zeros_like(got[2]))
        live = fn(torch.from_numpy(x[1:2, :4]),
                  {**prep, "wq": prep["wq"][1:2], "sw": prep["sw"][1:2]},
                  policy, eq="gti,gio->gto")
        assert torch.equal(got[1, :4], live[0]), policy


@pytest.mark.parametrize("M,K,N", [(2, 64, 200), (11, 256, 128),
                                   (8, 1024, 512)])
def test_dense_prequant_pipeline_matches_jax_exactly(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x, w = _x((M, K), rng), _w(1, K, N, rng)[0]
    want = np.asarray(_jax("dpa_matmul_prequant_pipeline", "fp4_dpa_packed")(
        jnp.asarray(x), jnp.asarray(w)))
    prep = TOPS.prep_weights(torch.from_numpy(w), "fp4_dpa_packed")
    got = TOPS.dpa_matmul_prequant_pipeline(torch.from_numpy(x), prep,
                                            "fp4_dpa_packed")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("eq,M", [("gti,gio->gto", 3), ("gti,gio->gto", 11),
                                  ("becd,edf->becf", 8)])
def test_grouped_prequant_pipeline_matches_jax_exactly(eq, M):
    x, w = _inputs(eq, 3, M, 256, 200, seed=M)
    want = np.asarray(_jax("dpa_grouped_prequant_pipeline", "fp4_dpa_packed",
                           eq)(jnp.asarray(x), jnp.asarray(w)))
    prep = TOPS.prep_grouped_weights(torch.from_numpy(w), "fp4_dpa_packed")
    got = TOPS.dpa_grouped_prequant_pipeline(torch.from_numpy(x), prep,
                                             "fp4_dpa_packed", eq=eq)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prequant_packed_equals_unpacked():
    """Nibble packing is pure relayout: the packed plain versions equal
    the unpacked ones bit for bit, dense and grouped, and every expert
    slice of the grouped version equals the dense one."""
    from repro_torch.core.packing import pack_fp4_axis
    rng = np.random.default_rng(9)
    E, M, K, N = 3, 8, 256, 128
    xq = torch.from_numpy(rng.integers(0, 16, (E, M, K)).astype(np.uint8))
    wq = torch.from_numpy(rng.integers(0, 16, (E, K, N)).astype(np.uint8))
    sx = torch.from_numpy(rng.uniform(0.1, 2, (E, M, 1)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.1, 2, (E, 1, N)).astype(np.float32))
    kw = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1")
    flat = GM.dpa_grouped_matmul_prequant(xq, wq, sx, sw, **kw)
    packed = GM.dpa_grouped_matmul_prequant(
        pack_fp4_axis(xq, 2), pack_fp4_axis(wq, 1), sx, sw, pack_x=True,
        pack_w=True, **kw)
    assert torch.equal(flat, packed)
    for e in range(E):
        dense = DM.dpa_matmul_prequant(
            pack_fp4_axis(xq[e], 1), pack_fp4_axis(wq[e], 0), sx[e], sw[e],
            pack_x=True, pack_w=True, **kw)
        assert torch.equal(dense, flat[e])


def test_grouped_prep_quantizes_the_f32_master():
    """The grouped load-time codes equal the reference's
    `_prep_grouped_weights` on the f32 master, bit for bit — and the bf16
    round trip the dense prep takes would change some of them."""
    rng = np.random.default_rng(3)
    w = _w(4, 256, 200, rng)
    pol = RPOL.get_policy("w4a8_kv4_attn8")
    wq, swp, _, pack_w = jax.jit(
        lambda v: ROPS._prep_grouped_weights(v, pol, 128, 128))(jnp.asarray(w))
    prep = TOPS.prep_grouped_weights(torch.from_numpy(w), "w4a8_kv4_attn8")
    assert prep["pack_w"] == pack_w and prep["n"] == 200
    assert tuple(prep["sw"].shape) == (4, 1, 256)
    np.testing.assert_array_equal(prep["wq"].numpy(), np.asarray(wq))
    np.testing.assert_array_equal(prep["sw"].numpy().view(np.uint32),
                                  np.asarray(swp).view(np.uint32))
    via_bf16 = TOPS.prep_grouped_weights(
        torch.from_numpy(w).to(torch.bfloat16), "w4a8_kv4_attn8")
    assert not torch.equal(via_bf16["wq"], prep["wq"])


@pytest.mark.parametrize("policy,route,ref_route", [
    ("w4a8_kv4_attn8", "cuda_grouped_fused", "pallas_grouped_fused"),
    ("fp4_dpa_packed", "cuda_grouped_prequant", "pallas_grouped_prequant"),
    ("fp8_dpa", "torch_fake_quant", "xla_fake_quant"),
    ("fp32", "torch_f32", "xla_f32")])
def test_grouped_routes_and_plain_fallbacks_match_jax(policy, route,
                                                      ref_route):
    """The port resolves the reference's route for every policy, and its
    plain fallbacks (`_gmm_fake_quant` without the pre-cast, `_gmm_f32`)
    agree with the reference's XLA routes."""
    ctx = dict(w_dtype="float32", eq=EQ, e=3, m=8, k=64, n=96)
    pol = RPOL.get_policy(policy)
    assert TPLAN.resolve("grouped_matmul", policy, **ctx).name == route
    assert RPLAN.resolve("grouped_matmul", pol, **ctx).name == ref_route
    if route.startswith("cuda"):
        return
    x, w = _inputs(EQ, 3, 8, 64, 96, seed=4)
    entry = RPLAN.route("grouped_matmul", ref_route)
    want = np.asarray(jax.jit(lambda a, b: entry.run(a, b, pol, eq=EQ))(
        jnp.asarray(x), jnp.asarray(w)))
    got = dpa_grouped_dot(torch.from_numpy(x), {"w": torch.from_numpy(w)},
                          policy, eq=EQ)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrappers_cpu_run_plain_versions_without_counting():
    rng = np.random.default_rng(1)
    x, w = _x((2, 8, 128), rng), _w(2, 128, 128, rng)
    prep = TOPS.prep_grouped_weights(torch.from_numpy(w), "w4a8_kv4_attn8")
    kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
    args = (torch.from_numpy(x), prep["wq"], prep["sw"])
    counts = (GM.dpa_grouped_matmul_fused.launches,
              GM.dpa_grouped_matmul_prequant.launches,
              DM.dpa_matmul_prequant.launches)
    assert torch.equal(GM.dpa_grouped_matmul_fused(*args, **kw),
                       GM.dpa_grouped_matmul_fused_ref(*args, **kw))
    xq = torch.zeros((2, 8, 64), dtype=torch.uint8)
    sx = torch.ones((2, 8, 1))
    pkw = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True, pack_w=True)
    GM.dpa_grouped_matmul_prequant(xq, prep["wq"], sx, prep["sw"], **pkw)
    DM.dpa_matmul_prequant(xq[0], prep["wq"][0], sx[0], prep["sw"][0], **pkw)
    assert counts == (GM.dpa_grouped_matmul_fused.launches,
                      GM.dpa_grouped_matmul_prequant.launches,
                      DM.dpa_matmul_prequant.launches)   # kernels only
    with pytest.raises(ValueError):                     # K does not contract
        GM.dpa_grouped_matmul_fused(args[0][..., :64], *args[1:], **kw)
    with pytest.raises(ValueError):                     # expert counts differ
        GM.dpa_grouped_matmul_fused(args[0][:1], *args[1:], **kw)
    with pytest.raises(ValueError):                     # sw shape
        GM.dpa_grouped_matmul_fused(args[0], args[1], args[2][:, :, :64],
                                    **kw)
    with pytest.raises(ValueError):                     # sx shape
        GM.dpa_grouped_matmul_prequant(xq, prep["wq"], sx[:, :4],
                                       prep["sw"], **pkw)
    with pytest.raises(ValueError):                     # unpacked K mismatch
        DM.dpa_matmul_prequant(xq[0], prep["wq"][0], sx[0], prep["sw"][0],
                               fmt_x="fp4_e2m1", fmt_w="fp4_e2m1",
                               pack_w=True)


@pytest.mark.parametrize("policy", ["fp32", "w4a8_kv4_attn8"])
def test_apply_grouped_linear_matches_jax(policy):
    """The grouped linear ("gti,gio->gto") through the plan, on the f32
    route and on the grouped fused kernel route."""
    from repro_torch.core.linear import (apply_grouped_linear,
                                         prepare_grouped_linear)
    RLIN = importlib.import_module("repro.core.linear")
    x, w = _inputs("gti,gio->gto", 3, 5, 128, 96, seed=8)
    want = np.asarray(jax.jit(lambda a, b: RLIN.apply_grouped_linear(
        {"w": b}, a, RPOL.get_policy(policy)))(jnp.asarray(x),
                                                jnp.asarray(w)))
    lin = {"w": torch.from_numpy(w)}
    if policy != "fp32":
        prepare_grouped_linear(lin, policy)
    got = apply_grouped_linear(lin, torch.from_numpy(x), policy)
    assert tuple(got.shape) == (3, 5, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
