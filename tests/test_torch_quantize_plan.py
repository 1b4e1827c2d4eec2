"""The row quantizers' launch plan (`repro_torch.kernels.quantize.
quantize_plan`) and a plain model of the kernel's decomposition
(`csrc/quantize_rows.cu`), which the CPU cannot run.

The model walks the kernel's loops in numpy: thread t of a row's group
takes chunks t, t + lanes, ... by tile (16 bytes of x on the vector
route; two elements, zero past the row's end, on the scalar route), the
row's absmax comes by the segmented xor butterfly (or a warp butterfly
and then the warps' maxima in order), the scale and the clipped
quotients by the contract, each code by the plain per-element cast, and
each chunk's codes are laid into the code bytes as the kernel's store
lays them: pairs first element in the low half, 32-bit words
little-endian, packed E2M1 with the even index in the low nibble.  The
result must equal `quantize_rows_ref` / `quantize_pack_rows_ref` bit for
bit, with every code byte written exactly once and every vector store
aligned to its width.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.formats import get_format  # noqa: E402
from repro_torch.core.quantize import encode_fp4, torch_dtype  # noqa: E402
from repro_torch.kernels import quantize as TQ  # noqa: E402

FMTS = ["fp8_e4m3", "fp8_e5m2", "fp4_e2m1", "packed", "fp16", "bf16",
        "fp32"]
XDT = {"f32": torch.float32, "bf16": torch.bfloat16}
SMEM_BYTES = 232448              # what one block may hold on an H100


def _inputs(M, K, seed, xdt):
    """(M, K) x in xdt: random rows, row 1 all zeros, as f32 numpy values
    and the torch tensor."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 3).astype(
        np.float32)).to(xdt)
    x[1 % M] = 0
    return x.to(torch.float32).numpy(), x


def _codes(y, fmt):
    """The plain per-element casts of the clipped quotients y (f32 numpy)
    -> integer codes (uint64) in the code's width."""
    t = torch.from_numpy(y)
    if fmt in ("fp4_e2m1", "packed"):
        c = encode_fp4(t)
    elif fmt == "fp32":
        c = t.view(torch.int32)
    else:
        c = t.to(torch_dtype(fmt))
        c = c.view(torch.uint8 if c.element_size() == 1 else torch.int16)
    bits = 8 * c.element_size()
    return c.numpy().astype(np.int64).astype(np.uint64) & ((1 << bits) - 1)


def _butterfly(a, lanes):
    """The kernel's max over a row's lanes: the xor butterfly within each
    warp (within the group of `lanes` <= 32), then, across warps, warp 0's
    value and the others' in order."""
    width = min(lanes, 32)
    a = a.reshape(-1, width)
    o = width // 2
    while o:
        a = np.maximum(a, a[:, np.arange(width) ^ o])
        o //= 2
    assert (a == a[:, :1]).all()              # every lane holds the max
    m = a[0, 0]
    for w in a[1:, 0]:
        m = np.maximum(m, w)
    return m


def model(x, M, K, xdt, fmt, aligned=True):
    """-> (code bytes, f32 scales) as the kernel under `quantize_plan`
    writes them."""
    pack = fmt == "packed"
    name = "fp4_e2m1" if pack else fmt
    plan = TQ.quantize_plan(M, K, xdt, name, pack=pack, aligned=aligned)
    W, lanes, nv, tiles = plan.width, plan.lanes, plan.nv, plan.tiles
    vector = plan.route.startswith("vector")
    chunks = -(-K // W)
    span = lanes * nv
    # every chunk belongs to exactly one (thread, tile, slot)
    t, j, i = np.meshgrid(np.arange(lanes), np.arange(tiles), np.arange(nv),
                          indexing="ij")
    q = (j * span + i * lanes + t).ravel()
    owner = np.broadcast_to(t, t.shape).ravel()[q < chunks]
    q = q[q < chunks]
    assert np.array_equal(np.sort(q), np.arange(chunks))
    f = get_format(name)
    target = np.float32(f.quant_target)
    inv = np.float32(1) / target
    code_bits = 4 if pack else 8 * torch.empty(
        (), dtype=torch_dtype(name)).element_size()
    out = np.zeros(M * K * code_bits // 8, np.uint8)
    hits = np.zeros(out.size, np.int64)
    scales = np.empty(M, np.float32)
    for r in range(M):
        row = np.zeros(chunks * W, np.float32)
        row[:K] = x[r]                         # the scalar route's zero tail
        seg = row.reshape(chunks, W)[q]
        a = np.zeros(lanes, np.float32)
        np.maximum.at(a, owner, np.abs(seg).max(axis=1))
        s = np.maximum(np.maximum(_butterfly(a, lanes), np.float32(1e-30))
                       * inv, np.float32(2.0 ** -126))
        scales[r] = s
        y = np.clip(seg / s, -target, target).astype(np.float32)
        c = _codes(y, fmt)                     # (chunks, W)
        first = (r * K + q * W) * code_bits // 8
        if vector:
            # pairs -> bits, low half first; words little-endian
            pair_bits = 8 if pack else 2 * code_bits
            pairs = c[:, 0::2] | (c[:, 1::2] << np.uint64(pair_bits // 2))
            nbytes = W * code_bits // 8
            stream = np.zeros((len(q), max(nbytes, 4)), np.uint8)
            for p in range(W // 2):
                for b in range(pair_bits // 8):
                    stream[:, p * pair_bits // 8 + b] = (
                        pairs[:, p] >> np.uint64(8 * b)) & np.uint64(255)
            assert (first % min(nbytes, 16) == 0).all()   # aligned stores
            for b in range(nbytes):
                out[first + b] = stream[:, b]
                np.add.at(hits, first + b, 1)
        else:
            live = q * W + 1 < K                # the pair's second code
            if pack:
                out[first] = (c[:, 0] | (c[:, 1] << np.uint64(4))).astype(
                    np.uint8)
                np.add.at(hits, first, 1)
                continue
            cb = code_bits // 8
            for e, keep in ((0, np.ones_like(live)), (1, live)):
                at = first[keep] + e * cb
                for b in range(cb):
                    out[at + b] = (c[keep, e] >> np.uint64(8 * b)) & \
                        np.uint64(255)
                    np.add.at(hits, at + b, 1)
    assert (hits == 1).all()                   # every byte written once
    return out, scales


def _plain_bytes(xt, fmt):
    q, s = TQ.quantize_pack_rows_ref(xt) if fmt == "packed" else \
        TQ.quantize_rows_ref(xt, fmt=fmt)
    return q.contiguous().view(torch.uint8).numpy().ravel(), s.numpy().ravel()


@pytest.mark.parametrize("xdt", ["f32", "bf16"])
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("K", [64, 128, 334, 335, 2560])
def test_kernel_model_matches_the_plain_version(K, fmt, xdt):
    M = 3
    if fmt == "packed" and K % 2:
        with pytest.raises(ValueError, match="K even"):
            TQ.quantize_plan(M, K, XDT[xdt], "fp4_e2m1", pack=True)
        return
    x, xt = _inputs(M, K, seed=K, xdt=XDT[xdt])
    got, got_s = model(x, M, K, XDT[xdt], fmt)
    want, want_s = _plain_bytes(xt, fmt)
    assert np.array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("M,K,xdt,fmt,aligned,route", [
    (4, 128, "bf16", "packed", False, "scalar"),          # an offset view
    (4, 128, "f32", "fp8_e5m2", False, "scalar"),
    (2, 65544, "bf16", "fp8_e4m3", True, "vector_reread"),
    (2, 16386, "f32", "packed", True, "scalar_reread"),   # K x 4 % 16 != 0
])
def test_kernel_model_on_the_other_routes(M, K, xdt, fmt, aligned, route):
    name = "fp4_e2m1" if fmt == "packed" else fmt
    plan = TQ.quantize_plan(M, K, XDT[xdt], name, pack=fmt == "packed",
                            aligned=aligned)
    assert plan.route == route
    x, xt = _inputs(M, K, seed=5, xdt=XDT[xdt])
    got, got_s = model(x, M, K, XDT[xdt], fmt, aligned=aligned)
    want, want_s = _plain_bytes(xt, fmt)
    assert np.array_equal(got_s.view(np.uint32), want_s.view(np.uint32))
    assert np.array_equal(got, want)


def _bisect_e2m1(y):
    """csrc/quantize_rows.cu `encode_e2m1` on unclipped quotients: the
    thresholds of encode_fp4 searched in three compares."""
    a = np.abs(y)
    hi = a >= np.float32(1.75)
    mid = a >= np.where(hi, np.float32(3.5), np.float32(0.75))
    t = np.where(hi, np.where(mid, 5.0, 2.5),
                 np.where(mid, 1.25, 0.25)).astype(np.float32)
    c = 4 * hi.astype(np.uint8) + 2 * mid.astype(np.uint8) + (a > t)
    return c.astype(np.uint8) | np.where(y < 0, 8, 0).astype(np.uint8)


def test_bisection_encode_equals_encode_fp4_of_the_clipped_value():
    """The kernel's E2M1 encode, unclipped, against the plain version's
    encode_fp4 of the value clipped to +-6: every f32 within 3000 ulps of
    each threshold and grid value, random values up to 8, the largest
    floats, zeros of both signs and NaN (code 0 both ways)."""
    marks = np.array([0.25, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.5, 3.0,
                      3.5, 4.0, 5.0, 6.0], np.float32).view(np.int32)
    near = (marks[:, None] + np.arange(-3000, 3001)).ravel().astype(
        np.int32).view(np.float32)
    rng = np.random.default_rng(2)
    a = np.concatenate([near, rng.uniform(0, 8, 1 << 18).astype(np.float32),
                        np.array([0, 1e-45, 1e-38, 7, 1e30, 3.4e38],
                                 np.float32)])
    y = np.concatenate([a, -a, np.array([np.nan], np.float32)])
    want = encode_fp4(torch.clamp(torch.from_numpy(y), -6, 6)).numpy()
    assert np.array_equal(_bisect_e2m1(y), want)


def test_plan_invariants():
    """At every K up to 600 and at the paths' and long shapes: the grid
    covers each row once, each chunk is held by one (thread, tile, slot)
    and the tiles are as few as the thread's slots allow, vectors only
    where K and the base are 16-byte aligned, a block's held bytes within
    an SM's shared memory, and short rows share a warp."""
    Ks = list(range(1, 601)) + [2560, 9728, 32768, 65536, 65544, 131072]
    for xdt, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
        for K in Ks:
            for aligned in (True, False):
                p = TQ.quantize_plan(37, K, xdt, "fp8_e4m3", aligned=aligned)
                threads = p.lanes * p.rows
                assert threads <= 1024 and threads % 32 == 0
                assert (p.lanes <= 32 and not p.lanes & (p.lanes - 1)) or \
                    (p.lanes % 32 == 0 and p.rows == 1)
                assert p.blocks * p.rows >= 37 > (p.blocks - 1) * p.rows
                vector = aligned and K * elem % 16 == 0
                assert p.route.startswith("vector") == vector
                assert p.width == (16 // elem if vector else 2)
                chunks = -(-K // p.width)
                assert 1 <= p.nv <= TQ.MAX_VECS
                assert p.tiles == -(-chunks // (p.lanes * p.nv))
                assert p.route.endswith("_reread") == (p.tiles > 1)
                assert p.tiles == 1 or (p.lanes, p.nv) == (1024,
                                                           TQ.MAX_VECS)
                held = p.rows * min(chunks, p.lanes * p.nv) * (
                    16 if vector else 2 * elem)
                assert held <= SMEM_BYTES
                if chunks <= 32 * TQ.MAX_VECS:
                    assert p.lanes <= 32 and p.rows == 128 // p.lanes
                    assert p.lanes * p.nv >= chunks
                if chunks <= 16 * TQ.MAX_VECS:
                    assert 32 // p.lanes >= 2          # rows share a warp


def test_plan_at_the_paths_shapes_and_its_refusals():
    bf16, f32 = torch.bfloat16, torch.float32
    # path D's K/V pre-pass (qwen3-4b hd 128) and granite's hd 64: x held
    # in registers, 4 (2) lanes a row, 8 (16) rows a warp
    assert TQ.quantize_plan(32768, 128, bf16, "fp4_e2m1", pack=True) == \
        TQ.QuantizePlan("vector", 8, 4, 32, 4, 1, 1024)
    assert TQ.quantize_plan(32768, 64, bf16, "fp8_e4m3") == \
        TQ.QuantizePlan("vector", 8, 2, 64, 4, 1, 512)
    # qwen3-4b's MLP activations: ten warps a row, one read
    assert TQ.quantize_plan(4096, 9728, bf16, "fp8_e4m3") == \
        TQ.QuantizePlan("vector", 8, 320, 1, 4, 1, 4096)
    assert TQ.quantize_plan(4096, 2560, f32, "fp8_e5m2") == \
        TQ.QuantizePlan("vector", 4, 160, 1, 4, 1, 4096)
    assert TQ.quantize_plan(130, 334, bf16, "fp16").route == "scalar"
    for args, kw, err in (((8, 33, bf16, "fp4_e2m1"), {"pack": True},
                           ValueError),
                          ((8, 32, bf16, "fp8_e4m3"), {"pack": True},
                           ValueError),
                          ((8, 32, bf16, "fp6_e3m2"), {}, ValueError),
                          ((0, 32, bf16, "fp16"), {}, ValueError),
                          ((8, 32, torch.float16, "fp16"), {}, TypeError)):
        with pytest.raises(err):
            TQ.quantize_plan(*args, **kw)
