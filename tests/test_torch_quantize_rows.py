"""Row quantizers: the port's plain versions vs the JAX Pallas kernels
`quantize_rows` / `quantize_pack_rows` (interpret mode under `jax.jit`),
at tolerance 0 on codes and scales, in every format of the format
table: E4M3, E5M2, E2M1 (one code per byte, and packed), fp16, bf16 and
f32.

Inputs hold exact rounding ties of each format (built from the row's
own scale and kept only where x / scale lands on the tie exactly), an
all-zero row, and a row count that is not a multiple of the reference's
bm (through the `quantize_pack` op: the reference pads the rows to bm
and cuts them back, the port's kernel takes any row count).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as RO  # noqa: E402
from repro.kernels import quantize as RQ  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.kernels import ops as TO  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402

FMTS = ["fp8_e4m3", "fp4_e2m1", "fp16", "bf16", "fp8_e5m2", "fp32"]
# FloatFormat.quant_target: E5M2 too is capped at 2^14, not its 57,344
TARGET = {"fp8_e4m3": 448.0, "fp4_e2m1": 6.0, "fp16": 16384.0,
          "bf16": 16384.0, "fp8_e5m2": 16384.0, "fp32": 16384.0}
# values halfway between two neighbours of each grid (round to even)
TIES = {"fp8_e4m3": [1.0625, 1.1875, 17.0, 240.0, 0.0068359375],
        "fp4_e2m1": [0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0],
        "fp16": [1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 1000.25],
        "bf16": [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 100.25],
        # the last one halfway between E5M2's subnormals 2^-16 and 2^-15
        "fp8_e5m2": [1.125, 1.375, 18.0, 22.0, 1.5 * 2.0 ** -16],
        "fp32": []}


def _scale(amax, target):
    """The kernels' scale recipe in f32: max(max(amax, 1e-30) *
    f32(1/target), 2^-126)."""
    inv = np.float32(1.0) / np.float32(target)
    return np.maximum(np.maximum(np.float32(amax), np.float32(1e-30)) * inv,
                      np.float32(2.0 ** -126))


def _inputs(fmt, M, K, seed):
    """(M, K) f32: random rows with planted ties, row 1 all zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((M, K)) * 3).astype(np.float32)
    x[1] = 0.0
    ties = TIES[fmt]
    for r in range(2, M):
        amax = np.float32(np.abs(x[r]).max())
        s = _scale(amax, TARGET[fmt])
        for j, t in enumerate(ties):
            col = (j * 7 + r) % K
            v = np.float32(t * s) * (1 if (r + j) % 2 else -1)
            # keep the tie only where it is exact and leaves amax alone
            if np.abs(v) < amax and np.float32(np.abs(v) / s) == t:
                x[r, col] = v
    return x


def _np(a):
    """The codes' bits (f32 codes too, so -0.0 differs from 0.0)."""
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _torch_np(t):
    if t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2):
        t = t.view(torch.uint8)
    elif t.dtype in (torch.float16, torch.bfloat16):
        t = t.view(torch.int16)
    elif t.dtype == torch.float32:
        t = t.view(torch.int32)
    return t.numpy().view(np.uint8 if t.dtype == torch.uint8 else
                          np.uint16 if t.dtype == torch.int16 else
                          np.uint32)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("K", [64, 334])
def test_plain_quantizer_matches_pallas_bit_for_bit(fmt, K):
    x = _inputs(fmt, 128, K, seed=K)
    want_q, want_s = RQ.quantize_rows(jnp.asarray(x), fmt=fmt)
    got_q, got_s = TQ.quantize_rows(torch.from_numpy(x), fmt=fmt)
    assert got_s.shape == (128, 1) and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(_torch_np(got_q), _np(want_q))
    assert float(got_s[1, 0]) > 0                  # the all-zero row


@pytest.mark.parametrize("K", [64, 334])
def test_plain_pack_quantizer_matches_pallas_bit_for_bit(K):
    x = _inputs("fp4_e2m1", 128, K, seed=K + 1)
    want_q, want_s = RQ.quantize_pack_rows(jnp.asarray(x))
    got_q, got_s = TQ.quantize_pack_rows(torch.from_numpy(x))
    assert got_q.shape == (128, K // 2) and got_q.dtype == torch.uint8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


@pytest.mark.parametrize("fmt,pack", [("fp8_e4m3", False),
                                      ("fp4_e2m1", True), ("bf16", False)])
def test_quantize_pack_op_pads_rows_like_the_reference(fmt, pack):
    """M = 130 is not a multiple of bm = 128: the reference pads the rows
    to 256 for its kernel and cuts back, the port quantizes the 130 rows
    as they are; the same rows come out.  bf16 input as well as f32."""
    x = _inputs(fmt, 130, 96, seed=7)
    for dtype in (np.float32, "bf16"):
        xt = torch.from_numpy(x)
        xj = jnp.asarray(x)
        if dtype == "bf16":
            xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
        want_q, want_s = RO.quantize_rows(xj, fmt, pack=pack)
        got_q, got_s = TO.quantize_rows(xt, fmt, pack=pack)
        assert got_q.shape[0] == got_s.shape[0] == 130
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np.testing.assert_array_equal(_torch_np(got_q), _np(want_q))


def test_quantize_pack_routes():
    pins = [(dict(fmt="fp4_e2m1", pack=True), "cuda_quantize_pack"),
            (dict(fmt="fp4_e2m1", pack=False), "cuda_quantize_rows"),
            (dict(fmt="fp16", pack=False), "cuda_quantize_rows")]
    for ctx, want in pins:
        assert exec_plan.resolve("quantize_pack", None, **ctx).name == want
    with pytest.raises(exec_plan.PlanError):
        exec_plan.resolve("quantize_pack", None, fmt="fp8_e4m3", pack=True)
    # the kernel routes on a CPU tensor run the plain version: no launch
    n = TQ.quantize_pack_rows.launches
    x = torch.from_numpy(_inputs("fp4_e2m1", 8, 32, seed=3))
    q, s = TO.quantize_rows(x, "fp4_e2m1", pack=True)
    ref_q, ref_s = exec_plan.route("quantize_pack", "torch_quantize").run(
        x, fmt="fp4_e2m1", pack=True)
    assert torch.equal(q, ref_q) and torch.equal(s, ref_s)
    assert TQ.quantize_pack_rows.launches == n


def test_off_the_cpu_the_wrappers_launch_or_raise():
    """Off the CPU every format of the table goes to the kernel (here it
    meets the device check: a meta tensor has no kernel); a name the
    table does not know is refused."""
    x = torch.empty((8, 32), device="meta")
    with pytest.raises(NotImplementedError, match="every format"):
        TQ.quantize_rows(x, fmt="fp6_e3m2")
    for call in [lambda f=f: TQ.quantize_rows(x, fmt=f) for f in FMTS] + [
            lambda: TQ.quantize_pack_rows(x)]:
        with pytest.raises(ValueError, match="unsupported device"):
            call()
