"""The fused DPA matmul: port vs the JAX reference pipeline.

The port's `dpa_matmul_fused_pipeline` on CPU tensors runs the kernel's
plain version over load-time prepared weights; the reference is
`jax.jit(repro.kernels.ops.dpa_matmul_fused_pipeline)`, whose Pallas
kernel runs in interpret mode and re-quantizes the weights per call.
Tolerance rtol 2e-5 / atol 2e-4: the reference's own pin between its
fused kernel and `ref.dpa_matmul_fused_ref` (same grids, same scales,
f32 sums in another order).  Shapes cover K and N padding (K=64 pads to
one 128 block, N=200 to 256) and M padding (3 -> 8).
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import dpa_matmul as DM  # noqa: E402
from repro_torch.kernels import ops as TOPS  # noqa: E402

ROPS = importlib.import_module("repro.kernels.ops")
RPOL = importlib.import_module("repro.core.policy")

# (fmt_x, fmt_w) pairs: (fp8, packed fp4) and (fp8, fp8)
POLICIES = ["w4a8_kv4_attn8", "fp8_dpa_fused"]
RTOL, ATOL = 2e-5, 2e-4


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x *= np.exp2(rng.integers(-4, 4, size=(M, 1))).astype(np.float32)
    w = (rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32)
    return x, w


@functools.lru_cache(maxsize=None)
def _jax_pipeline(policy):
    return jax.jit(functools.partial(ROPS.dpa_matmul_fused_pipeline,
                                     policy=policy))


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("M", [3, 8, 32])
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("N", [128, 200])
def test_fused_pipeline_matches_jax(policy, M, K, N):
    x, w = _inputs(M, K, N, seed=M * 1000 + K + N)
    want = np.asarray(_jax_pipeline(policy)(jnp.asarray(x), jnp.asarray(w)))
    prep = TOPS.prep_weights(torch.from_numpy(w), policy)
    got = TOPS.dpa_matmul_fused_pipeline(torch.from_numpy(x), prep, policy)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("policy", POLICIES)
def test_load_time_prep_matches_per_call_quantization(policy):
    """The port prepares weights once; the codes and scales are the ones
    the reference computes on every call, bit for bit."""
    _, w = _inputs(4, 256, 200, seed=7)
    pol = RPOL.get_policy(policy)
    wq, swp, _, pack_w = jax.jit(
        lambda v: ROPS._prep_weights(v, pol, 128, 128))(jnp.asarray(w))
    prep = TOPS.prep_weights(torch.from_numpy(w), policy)
    assert prep["pack_w"] == pack_w and prep["n"] == 200
    np.testing.assert_array_equal(
        prep["wq"].view(torch.uint8).numpy(),
        np.asarray(wq).view(np.uint8))
    np.testing.assert_array_equal(prep["sw"].numpy().view(np.uint32),
                                  np.asarray(swp).view(np.uint32))


def test_bf16_activations_match_jax():
    """Full-width serving runs bf16 activations over weights prepared from
    the bf16-cast master (apply_linear's cast)."""
    x, w = _inputs(4, 256, 128, seed=11)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jax_pipeline("w4a8_kv4_attn8")(
        xb, jnp.asarray(w).astype(jnp.bfloat16))
    prep = TOPS.prep_weights(torch.from_numpy(w).to(torch.bfloat16),
                             "w4a8_kv4_attn8")
    got = TOPS.dpa_matmul_fused_pipeline(
        torch.from_numpy(x).to(torch.bfloat16), prep, "w4a8_kv4_attn8")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)   # one bf16 ulp


def test_plain_version_is_row_invariant():
    """Row i of an M-row call equals the same row alone, bit for bit —
    the property the engine-vs-generate pin needs from the plain path."""
    x, w = _inputs(8, 256, 128, seed=5)
    prep = TOPS.prep_weights(torch.from_numpy(w), "w4a8_kv4_attn8")
    full = DM.dpa_matmul_fused_ref(torch.from_numpy(x), prep["wq"],
                                   prep["sw"], fmt_x="fp8_e4m3",
                                   fmt_w="fp4_e2m1", pack_w=True)
    for i in range(8):
        one = DM.dpa_matmul_fused_ref(torch.from_numpy(x[i:i + 1]),
                                      prep["wq"], prep["sw"],
                                      fmt_x="fp8_e4m3", fmt_w="fp4_e2m1",
                                      pack_w=True)
        assert torch.equal(full[i:i + 1], one)


def test_wrapper_cpu_runs_plain_version_without_counting():
    x, w = _inputs(8, 128, 128, seed=3)
    prep = TOPS.prep_weights(torch.from_numpy(w), "w4a8_kv4_attn8")
    before = DM.dpa_matmul_fused.launches
    args = (torch.from_numpy(x), prep["wq"], prep["sw"])
    kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
    assert torch.equal(DM.dpa_matmul_fused(*args, **kw),
                       DM.dpa_matmul_fused_ref(*args, **kw))
    assert DM.dpa_matmul_fused.launches == before    # counts kernels only
    with pytest.raises(ValueError):
        DM.dpa_matmul_fused(args[0][:, :64], *args[1:], **kw)
    with pytest.raises(TypeError):
        DM.dpa_matmul_fused(args[0].to(torch.float16), *args[1:], **kw)
    with pytest.raises(ValueError):
        DM.dpa_matmul_fused(args[0], args[1], args[2][:, :64], **kw)
