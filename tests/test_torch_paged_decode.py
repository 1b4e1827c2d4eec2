"""Paged decode attention: the port's plain version vs the reference's
Pallas block-table kernel (interpret mode) and its `jnp_gather` route.

The port's `paged_decode_attention` on CPU tensors runs its plain version
(gather + `dpa_attention`).  Inputs are the same numpy draws on both
sides; caches are built by each side's own quantizer and relayout
(bit-identical, see test_torch_kvcache.py).

Tolerance: the two frameworks sum the QK^T and PV products in different
orders, so logits differ in the last f32 bits; exp then differs by ulps,
and a probability lands on the other E4M3 neighbour only when p / psq
sits at a rounding midpoint.  Measured on these inputs: max error
2.4e-7 (no code flipped); the pin is 1e-4 absolute on outputs of
magnitude ~1, which a single flipped p code would exceed.
"""
import functools
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import kvcache as TKV  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import paged_decode as TPD  # noqa: E402

RKV = importlib.import_module("repro.core.kvcache")
RPLAN = importlib.import_module("repro.core.exec_plan")

PRESETS = ["kv4_attn8_packed", "attn_fp8_dpa", "kv8_attn_f32",
           "kv16_attn_f32", "attn_fp16_dpa"]
PS, N_KV, HD, H = 8, 2, 16, 4
TOL = 1e-4


def _caches(pol, lengths, seed=3, hd=HD):
    B = len(lengths)
    S = max(-(-n // PS) for n in lengths) * PS
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, N_KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, N_KV, hd)).astype(np.float32)
    kw = dict(fmt=pol.fmt_kv, packed=pol.kv_packed)
    ref = RKV.paged_from_contiguous(
        RKV.update_kv_cache(RKV.init_kv_cache(B, S, N_KV, hd, **kw),
                            jnp.asarray(k), jnp.asarray(v), 0, **kw),
        lengths, page_size=PS)
    got = TKV.paged_from_contiguous(
        TKV.update_kv_cache(TKV.init_kv_cache(B, S, N_KV, hd, **kw),
                            torch.from_numpy(k), torch.from_numpy(v), 0,
                            **kw),
        lengths, page_size=PS)
    return ref, got


@functools.lru_cache(maxsize=None)
def _route(name, preset, hd=HD):
    pol = importlib.import_module("repro.core.policy").get_policy(preset)
    entry = RPLAN.route("paged_decode", name)
    return jax.jit(lambda q, c, p: entry.run(q, c, p, policy=pol,
                                             scale=hd ** -0.5))


def _port(q, cache, pos, pol):
    return TPD.paged_decode_attention(
        q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
        cache["v_scale"], cache["block_table"], pos, fmt=pol.fmt_attn,
        fmt_kv=pol.fmt_kv, kv_packed=pol.kv_packed,
        scale=q.shape[-1] ** -0.5)


def _compare(preset, lengths, positions, seed, hd=HD):
    pol = get_policy(preset)
    ref, got = _caches(pol, lengths, hd=hd)
    q = np.random.default_rng(seed).standard_normal(
        (len(lengths), 1, H, hd)).astype(np.float32)
    pos = np.asarray(positions, np.int32)
    out = _port(torch.from_numpy(q), got, torch.from_numpy(pos), pol).numpy()
    errs = []
    for name in ("pallas_block_table", "jnp_gather"):
        want = np.asarray(_route(name, preset, hd)(jnp.asarray(q), ref,
                                                   jnp.asarray(pos)))
        assert out.shape == want.shape
        errs.append(float(np.max(np.abs(out - want))))
    return errs


@pytest.mark.parametrize("preset", PRESETS)
def test_plain_matches_pallas_kernel_and_gather(preset):
    lengths = [13, 5, 17]                     # partial tail pages
    errs = _compare(preset, lengths, [n - 1 for n in lengths], seed=9)
    assert max(errs) <= TOL, errs


@pytest.mark.parametrize("preset", PRESETS)
def test_head_dim_64_matches_pallas_kernel_and_gather(preset):
    """granite-moe-1b's head dim (64, H/KV = 2), which the CUDA kernel
    serves beside qwen3-4b's 128."""
    lengths = [13, 5, 17]
    errs = _compare(preset, lengths, [n - 1 for n in lengths], seed=10,
                    hd=64)
    assert max(errs) <= TOL, errs
    assert 64 in TPD.KERNEL_HEAD_DIMS and 128 in TPD.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("positions", [[0, 16], [7, 8], [15, 3]])
def test_mid_page_positions(positions):
    errs = _compare("kv4_attn8_packed", [17, 17], positions, seed=11)
    assert max(errs) <= TOL, errs


def test_idle_slot_on_scratch_page_and_no_launch_on_cpu():
    pol = get_policy("kv4_attn8_packed")
    _, got = _caches(pol, [13, 9, 1])
    got["block_table"][2] = 0                 # idle slot: all scratch
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 1, H, HD)).astype(np.float32))
    pos = torch.tensor([12, 8, 0], dtype=torch.int32)
    before = TPD.paged_decode_attention.launches
    out = _port(q, got, pos, pol)
    assert TPD.paged_decode_attention.launches == before
    assert torch.isfinite(out).all()
    # the idle row attends the scratch page's zero row: output zero
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    with pytest.raises(ValueError):
        _port(q, got, pos.to(torch.int64), pol)
    with pytest.raises(ValueError):
        _port(q[:, :0], got, pos, pol)    # no query token
    # two query tokens a request: the verify fold's plain version, row i
    # at positions + i, with no launch either
    two = _port(q.expand(3, 2, H, HD).contiguous(), got, pos, pol)
    assert TPD.paged_decode_attention.launches == before
    assert torch.equal(two[:, :1], out)
