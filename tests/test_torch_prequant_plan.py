"""The prequant kernel's launch plan and the exactness it rests on.

`csrc/dpa_prequant.cu` multiplies E2M1 codes on the int8 tensor cores as
2 * e2m1(c) (magnitudes 0, 1, 2, 3, 4, 6, 8, 12, sign from bit 3), sums
in int32 over any split of K across a thread-block cluster, and returns
`((float)acc * 0.25 * sx) * sw`.  That equals the plain version bit for
bit as long as |acc| <= 144 K stays below 2^24, which `prequant_plan`
guarantees by refusing K >= 2^16.  Here, on the CPU:

- the plan at every shape `chip_smoke.py` and path B (granite-moe-1b
  under `fp4_dpa_packed`) launch: the split divides K / 128, the cluster
  has at most 8 blocks, the grid reaches 132 blocks wherever K allows,
  and the split is the smallest that does;
- the plan, and with it the wrapper, refuses what the kernel cannot
  take exactly;
- the integer route (int64 sums of the doubled codes here) against
  `dpa_matmul_prequant_ref` and the JAX reference, tolerance 0, on random
  codes and on all codes at +-6 at the largest K the plan takes, where
  |acc| is at its maximum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as RREF  # noqa: E402
from repro_torch.kernels import dpa_grouped_matmul as GM  # noqa: E402
from repro_torch.kernels import dpa_matmul as DM  # noqa: E402

KW = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True, pack_w=True)
# 2 * e2m1 of the magnitude code (low three bits)
DOUBLED = np.array([0, 1, 2, 3, 4, 6, 8, 12], np.int64)
K_MAX = DM.K_EXACT - DM.BK             # the largest K the plan takes
PATH_SHAPES = [(E, K, N, M) for E in (1, 32)
               for K, N in ((1024, 1024), (1024, 512), (512, 1024))
               for M in (1, 8, 11, 16, 17, 64)]


def _splits(K):
    return [s for s in range(1, DM.MAX_CLUSTER + 1) if (K // DM.BK) % s == 0]


def _blocks(E, M, N, bn, split, row_tile):
    return E * -(-M // row_tile) * (N // bn) * split


@pytest.mark.parametrize("E,K,N,M", PATH_SHAPES)
def test_plan_fills_the_card_at_the_path_shapes(E, K, N, M):
    p = DM.prequant_plan(E, M, K, N)
    assert p.split in _splits(K) and p.split <= DM.MAX_CLUSTER
    assert p.bn in DM.COL_TILES and N % p.bn == 0
    assert p.bn * p.row_tile <= DM.MAX_TILE
    assert p.row_tile == min(t for t in DM.ROW_TILES if t >= min(M, 64))
    assert p.blocks == _blocks(E, M, N, p.bn, p.split, p.row_tile)
    most = _blocks(E, M, N, 16, _splits(K)[-1], p.row_tile)
    if most >= DM.SMS:
        assert p.blocks >= DM.SMS
        # no smaller split reaches the card with any column tile
        for s in _splits(K):
            if s >= p.split:
                break
            assert all(_blocks(E, M, N, bn, s, p.row_tile) < DM.SMS
                       for bn in DM.COL_TILES
                       if bn * p.row_tile <= DM.MAX_TILE)
    else:
        assert (p.bn, p.split) == (16, _splits(K)[-1])


@pytest.mark.parametrize("E,K,N,want", [
    (1, 1024, 1024, (16, 4, 256)),    # granite wq, wo: 64 tiles x 4
    (1, 1024, 512, (16, 8, 256)),     # wk, wv: 32 tiles x 8
    (32, 1024, 512, (64, 1, 256)),    # experts wg, wu
    (32, 512, 1024, (64, 1, 512)),    # experts wd
])
def test_plan_at_path_b_decode(E, K, N, want):
    """Path B's decode step (2 rows padded to M = 8)."""
    p = DM.prequant_plan(E, 8, K, N)
    assert (p.bn, p.split, p.blocks) == want


@pytest.mark.parametrize("E,M,K,N", [
    (1, 8, DM.K_EXACT, 64),           # |acc| could pass 2^24
    (1, 8, DM.K_EXACT + DM.BK, 64),
    (1, 8, 1000, 64),                 # K not a multiple of 128
    (1, 8, 64, 64),
    (1, 8, 0, 64),
    (1, 8, 1024, 24),                 # N not a multiple of the column tile
    (1, 8, 1024, 8),
    (0, 8, 1024, 64),
    (1, 0, 1024, 64),
    (65536, 8, 1024, 64),             # grid z
])
def test_plan_raises(E, M, K, N):
    with pytest.raises(ValueError):
        DM.prequant_plan(E, M, K, N)


def test_plan_is_memoized():
    DM.prequant_plan(32, 8, 1024, 512)
    hits = DM.prequant_plan.cache_info().hits
    assert DM.prequant_plan(32, 8, 1024, 512) is \
        DM.prequant_plan(32, 8, 1024, 512)
    assert DM.prequant_plan.cache_info().hits == hits + 2


def _packed(shape, rng, choices=None):
    if choices is None:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return np.asarray(choices, np.uint8)[rng.integers(0, len(choices),
                                                      shape)]


@pytest.mark.parametrize("K,bad", [(DM.K_EXACT, "K"), (1024, "N"),
                                   (1024, "align")])
def test_wrapper_refuses_before_launching(K, bad):
    """`launch_prequant` routes its shape checks through the plan (K <
    2^16 is new) and checks the codes' alignment, before it loads the
    kernel library."""
    rng = np.random.default_rng(0)
    N = 24 if bad == "N" else 64
    xq = torch.from_numpy(_packed((8, K // 2), rng))
    if bad == "align":
        buf = torch.zeros(8 * K // 2 + 1, dtype=torch.uint8)
        xq = buf[1:].view(8, K // 2)
        assert xq.is_contiguous() and xq.data_ptr() % 16
    wq = torch.from_numpy(_packed((K // 2, N), rng))
    sx, sw = torch.ones(8, 1), torch.ones(1, N)
    out = torch.empty(8, N)
    with pytest.raises(ValueError):
        DM.launch_prequant(xq, wq, sx, sw, out, 1, 8, K, N, what="test",
                           **KW)


def _codes(packed, axis):
    """Packed bytes -> E2M1 codes, low nibble first along `axis`."""
    lo, hi = packed & 15, packed >> 4
    return np.stack([lo, hi], axis=axis + 1).reshape(
        packed.shape[:axis] + (2 * packed.shape[axis],)
        + packed.shape[axis + 1:])


def _doubled(codes):
    return np.where(codes & 8, -1, 1) * DOUBLED[codes & 7]


def _integer_route(xq, wq, sx, sw):
    """The kernel's arithmetic: int64 sums of the doubled codes, times
    0.25 in f32, then the two rounded scale products."""
    acc = np.einsum("...mk,...kn->...mn", _doubled(_codes(xq, xq.ndim - 1)),
                    _doubled(_codes(wq, wq.ndim - 2)))
    assert np.abs(acc).max() < 2 ** 24
    p = acc.astype(np.float32) * np.float32(0.25)
    return (p * sx) * sw


def _scales(shape, rng):
    return (rng.random(shape) + 0.05).astype(np.float32)


@pytest.mark.parametrize("E,M,K,N,seed", [
    (1, 8, 1024, 64, 0), (1, 11, 512, 48, 1), (1, 17, 384, 16, 2),
    (4, 8, 256, 32, 3), (3, 64, 128, 64, 4)])
def test_integer_route_equals_plain_version(E, M, K, N, seed):
    rng = np.random.default_rng(seed)
    xq, wq = _packed((E, M, K // 2), rng), _packed((E, K // 2, N), rng)
    sx, sw = _scales((E, M, 1), rng), _scales((E, 1, N), rng)
    want = GM.dpa_grouped_matmul_prequant_ref(
        *(torch.from_numpy(a) for a in (xq, wq, sx, sw)), **KW).numpy()
    got = _integer_route(xq, wq, sx, sw)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", ["all +6 x all -6", "random signs"])
def test_integer_route_at_the_largest_acc(case):
    """Every code at +-6 (0x7 / 0xF) at K = 2^16 - 128: |acc| = 36 K, the
    largest the plan admits, against the port's plain version and the
    JAX reference (`repro.kernels.ref.dpa_matmul_ref`, unpacked codes)."""
    rng = np.random.default_rng(7)
    M, N = 4, 16
    if case == "all +6 x all -6":
        xq = np.full((M, K_MAX // 2), 0x77, np.uint8)
        wq = np.full((K_MAX // 2, N), 0xFF, np.uint8)
    else:
        six = (0x77, 0x7F, 0xF7, 0xFF)
        xq, wq = _packed((M, K_MAX // 2), rng, six), \
            _packed((K_MAX // 2, N), rng, six)
    sx, sw = _scales((M, 1), rng), _scales((1, N), rng)
    got = _integer_route(xq, wq, sx, sw)
    want = DM.dpa_matmul_prequant_ref(
        *(torch.from_numpy(a) for a in (xq, wq, sx, sw)), **KW).numpy()
    jax_want = np.asarray(RREF.dpa_matmul_ref(
        jnp.asarray(_codes(xq, 1)), jnp.asarray(_codes(wq, 0)),
        jnp.asarray(sx), jnp.asarray(sw), fmt_x="fp4_e2m1",
        fmt_w="fp4_e2m1"))
    if case == "all +6 x all -6":
        np.testing.assert_array_equal(
            got, (np.float32(-36.0 * K_MAX) * sx) * sw)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32),
                                  jax_want.view(np.uint32))
    assert DM.prequant_plan(1, M, K_MAX, N).split in _splits(K_MAX)


def test_doubled_codes_cover_the_e2m1_grid():
    """The int8 map is 2 * e2m1 for all 16 codes (-0 -> 0)."""
    from repro_torch.core.quantize import decode_fp4
    codes = np.arange(16, dtype=np.uint8)
    vals = decode_fp4(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(_doubled(codes), 2 * vals)
    assert _doubled(codes).tolist() == [
        0, 1, 2, 3, 4, 6, 8, 12, 0, -1, -2, -3, -4, -6, -8, -12]
