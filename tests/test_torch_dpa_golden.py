"""The port's DPA golden model against the pinned vectors, without JAX.

`tests/golden/dpa_vectors.npz` holds seeded operand codes and the
reference model's outputs for every (fmt_ab, fmt_acc, N) mode of Table I,
a finite batch and a full-code-space (specials) batch each.  Here the
port's `core.dpa.dpa_codes` replays every batch bit for bit, and the port
regenerates the whole file from its seed with its own copy of
`tests/golden/generate_dpa_vectors.py`'s logic (read, not imported: it
imports the reference), its own model and its own oracle, array for
array.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import dpa, formats as F, oracle  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dpa_vectors.npz")
MODES = [("fp16", "fp32", 2), ("fp8_e4m3", "fp32", 4),
         ("fp4_e2m1", "fp32", 8), ("fp32", "fp32", 1),
         ("fp16", "fp16", 2), ("fp8_e4m3", "fp16", 4)]
LANES = 256
SEED = 20260801
TAGS = [(f"{a}_x{n}_{c}_{kind}", a, c) for a, c, n in MODES
        for kind in ("finite", "specials")]


@pytest.fixture(scope="module")
def vectors():
    with np.load(GOLDEN) as v:
        return {name: v[name] for name in v.files}


@pytest.mark.parametrize("tag,fmt_ab,fmt_acc", TAGS,
                         ids=[t for t, _, _ in TAGS])
def test_golden_replay(vectors, tag, fmt_ab, fmt_acc):
    a, b, c = (vectors[f"{tag}__{k}"] for k in "abc")
    got = dpa.dpa_codes(a, b, c, fmt_ab, fmt_acc).numpy()
    want = vectors[f"{tag}__out"]
    bad = got != want.astype(np.int64)
    assert not bad.any(), (f"{tag}: {bad.sum()}/{bad.size} lanes differ; "
                           f"first got {hex(int(got[bad][0]))} want "
                           f"{hex(int(want[bad][0]))}")


def _finite_codes(rng, fmt, shape):
    """generate_dpa_vectors._finite_codes: non-finite codes lose their
    top mantissa bit and exponent (c & (man_mask >> 1))."""
    c = rng.integers(0, 1 << fmt.bits, size=shape).astype(np.uint32)
    if fmt.special != "none":
        _, _, _, _, is_inf, is_nan = F.decode(c, fmt)
        c = np.where((is_inf | is_nan).numpy(), c & (fmt.man_mask >> 1), c)
    return c


def _window_bound_ok(a, b, c, out, fa, fc, n):
    """generate_dpa_vectors._check_against_oracle: the model equals the
    exact oracle, or (cancellation below the window) lies within the
    window's bound."""
    want = oracle.dpa_exact(a, b, c, fa, fc)
    gf = F.codes_to_np(out, fc).astype(np.float64)
    wf = F.codes_to_np(want, fc).astype(np.float64)
    mism = (out != want) & ~(np.isnan(gf) & np.isnan(wf))
    if not mism.any():
        return True
    W = dpa.default_window_bits(fc, n)
    av = F.codes_to_np(a, fa).astype(np.float64)
    bv = F.codes_to_np(b, fa).astype(np.float64)
    cv = F.codes_to_np(c, fc).astype(np.float64)
    mags = np.concatenate([np.abs(av * bv), np.abs(cv)[:, None]], 1)
    anchor = np.log2(np.maximum(mags.max(1), 1e-300)) + 1
    return not (mism & ~(np.abs(gf - wf) <= 2.0 ** (anchor - W + 3))).any()


def regenerate():
    """The generator's arrays, from its seed, by the port."""
    rng = np.random.default_rng(SEED)
    arrays = {}
    for fmt_ab, fmt_acc, n in MODES:
        fa, fc = F.get_format(fmt_ab), F.get_format(fmt_acc)
        batches = {"finite": (_finite_codes(rng, fa, (LANES, n)),
                              _finite_codes(rng, fa, (LANES, n)),
                              _finite_codes(rng, fc, (LANES,)))}
        if fa.special != "none" or fc.special != "none":
            batches["specials"] = (
                rng.integers(0, 1 << fa.bits, (LANES, n)).astype(np.uint32),
                rng.integers(0, 1 << fa.bits, (LANES, n)).astype(np.uint32),
                rng.integers(0, 1 << fc.bits,
                             (LANES,), dtype=np.uint64).astype(np.uint32))
        for kind, (a, b, c) in batches.items():
            out = dpa.dpa_codes(a, b, c, fa, fc).numpy().astype(np.uint32)
            tag = f"{fmt_ab}_x{n}_{fmt_acc}_{kind}"
            if kind == "finite":
                assert _window_bound_ok(a, b, c, out, fa, fc, n), tag
            for name, arr in (("a", a), ("b", b), ("c", c), ("out", out)):
                arrays[f"{tag}__{name}"] = arr
    return arrays


@pytest.fixture(scope="module")
def regenerated():
    return regenerate()


def test_regenerated_file_has_every_array(vectors, regenerated):
    assert set(regenerated) == set(vectors)
    for fmt_ab, fmt_acc, n in MODES:
        assert f"{fmt_ab}_x{n}_{fmt_acc}_finite__out" in regenerated


@pytest.mark.parametrize("tag", [t for t, _, _ in TAGS])
def test_regenerated_arrays_equal_the_file(vectors, regenerated, tag):
    for k in ("a", "b", "c", "out"):
        name = f"{tag}__{k}"
        assert regenerated[name].dtype == vectors[name].dtype, name
        np.testing.assert_array_equal(regenerated[name], vectors[name],
                                      err_msg=name)
