"""The port's analysis on the CPU: the hardware model (`hwmodel/`), the
analytic cost census (`launch/analytic.py`), the roofline
(`launch/roofline.py`) and the per-launch census (`kernels/census.py`)
behind the launch counters.

  hwmodel      every public function and constant of the port's copy
               equals the reference's exactly (==) over the reference
               tests' inputs and a grid (n 32/64/128, p 11/24, the Fig. 6
               delays, every Mode); the paper's headline figures, as
               tests/test_hwmodel.py asserts them, on the port's copy.
  analytic     forward_macs, cell_flops_per_device,
               cell_hbm_bytes_per_device and model_flops equal the
               reference's exactly for every arch x applicable SHAPES
               cell x cards in {1, 256}, one case each.
  census       each bound of PERF.md's kernel table at its row's shape,
               to the table's printed digits; a layer's bound is the sum
               of its launches' maxima.
  counters     snapshot / diff / add carry the work through a capture
               and its replays.
  roofline     the CLI in a subprocess with jax and repro blocked;
               route_table; the checks chip_smoke.py makes of the
               route tables.

The reference is imported only as the parity oracle; its outputs are
computed once per module (fixtures).
"""
import dataclasses
import importlib.util
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import cell_applicable as ref_applicable  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.hwmodel import area as RA  # noqa: E402
from repro.hwmodel import energy as RE  # noqa: E402
from repro.hwmodel import throughput as RT  # noqa: E402
from repro.hwmodel import timing as RTM  # noqa: E402
from repro.launch import analytic as RAN  # noqa: E402
from repro.launch import hlo_analysis as RH  # noqa: E402

from repro_torch.configs import (LONG_CTX_ARCHS, SHAPES,  # noqa: E402
                                 cell_applicable, get_config, list_archs)
from repro_torch.hwmodel import area as A  # noqa: E402
from repro_torch.hwmodel import energy as E  # noqa: E402
from repro_torch.hwmodel import throughput as T  # noqa: E402
from repro_torch.hwmodel import timing as TM  # noqa: E402
from repro_torch.core.policy import get_policy  # noqa: E402
from repro_torch.kernels import census as C  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402
from repro_torch.launch import analytic as AN  # noqa: E402
from repro_torch.launch import roofline as R  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# -----------------------------------------------------------------------------
# hwmodel: the port's copy against the reference
# -----------------------------------------------------------------------------

NS = (32, 64, 128)
PS = (11, 24)
SHIFTER_PS = (150, 180, 200, 250, 300, 350, 400, 420, 500, 800)
MULT_NS = (0.8, 0.86, 0.88, 1.0, 1.2, 1.38, 1.5, 1.6, 2.0)
AREA_NS = (0.6, 0.7, 0.8, 0.85, 1.0, 1.2)
MODULES = ((A, RA), (E, RE), (T, RT), (TM, RTM))


def _public(mod):
    return sorted(n for n in vars(mod) if not n.startswith("_")
                  and getattr(getattr(mod, n), "__module__", mod.__name__)
                  in (mod.__name__, None) and not inspect.ismodule(
                      getattr(mod, n)))


def _plain(v):
    """Mode dataclasses (one class per package) as tuples, containers
    element by element."""
    if dataclasses.is_dataclass(v):
        return ("Mode",) + dataclasses.astuple(v)
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("mod,ref", MODULES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, _ in
                              MODULES])
def test_hwmodel_names_and_constants_equal_the_reference(mod, ref):
    names = _public(mod)
    assert names == _public(ref)
    for n in names:
        if not callable(getattr(mod, n)):
            assert _plain(getattr(mod, n)) == _plain(getattr(ref, n)), n


def _hw_cases():
    modes = [m.name for m in RT.MODES]
    yield "barrel_shifter_muxes", [(n,) for n in NS], {}
    yield "reconfig_extra_muxes", [(n,) for n in NS], {}
    yield "reconfig_overhead", [(n,) for n in NS], {}
    yield "multilane_muxes", [(n,) for n in NS], {}
    yield "multilane_overhead", [(n,) for n in NS], {}
    yield "array_multiplier_cells", [(p,) for p in PS], {}
    yield "multimode_multiplier_extra", [(p, s) for p in PS
                                         for s in (2, 4)], {}
    yield "transdot_area_ratio", [(d,) for d in AREA_NS], {}
    yield "energy_per_flop", [(m,) for m in modes], {}
    yield "energy_per_op", [(m,) for m in modes], {}
    yield "efficiency_vs_fp32", [(m,) for m in modes], {}
    yield "gemm_energy_mj", [(64, 128, 256, f) for f in RE._POLICY_MODE], {}
    yield "peak_flops_scale", [(f,) for f in RT.PEAK_SCALE_VS_BF16], {}
    yield "shifter_area", [(d, s) for d in SHIFTER_PS
                           for s in ("single", "multilane", "reconfig")], {}
    for pipe in (False, True):
        yield "multiplier_area", [(d, s) for d in MULT_NS
                                  for s in ("transdot", "separated")], \
            {"pipelined": pipe}
        yield "multiplier_min_delay", [(s,) for s in ("transdot",
                                                      "separated")], \
            {"pipelined": pipe}


def _mode_cases():
    """The functions of a Mode, each at every mode (by name)."""
    for m in RT.MODES:
        for unit in ("transdot", "fpnew"):
            yield "macs_per_cycle", m.name, (unit,)
            yield "gflops", m.name, (unit,)
        yield "latency_cycles", m.name, ()
        yield "area_efficiency", m.name, ()
        yield "area_efficiency_range", m.name, ()
        for d in AREA_NS:
            yield "area_efficiency_at_delay", m.name, (d,)


def _find(name, pkg):
    for mod, ref in MODULES:
        if hasattr(mod, name):
            return mod if pkg == "port" else ref
    raise KeyError(name)


@pytest.mark.parametrize("name,args,kw", list(_hw_cases()),
                         ids=lambda v: v if isinstance(v, str) else None)
def test_hwmodel_functions_equal_the_reference(name, args, kw):
    fn, ref = _find(name, "port"), _find(name, "ref")
    for a in args:
        assert getattr(fn, name)(*a, **kw) == getattr(ref, name)(*a, **kw), \
            (name, a, kw)


def test_hwmodel_mode_functions_equal_the_reference():
    for name, mode, rest in _mode_cases():
        got = getattr(T, name)(T.MODE_BY_NAME[mode], *rest)
        want = getattr(RT, name)(RT.MODE_BY_NAME[mode], *rest)
        assert got == want, (name, mode, rest)


def test_hwmodel_every_public_function_is_exercised():
    done = {c[0] for c in _hw_cases()} | {c[0] for c in _mode_cases()}
    funcs = {n for mod, _ in MODULES for n in _public(mod)
             if callable(getattr(mod, n)) and not inspect.isclass(
                 getattr(mod, n))}
    assert funcs <= done, funcs - done


# the paper's headline figures on the port's copy (tests/test_hwmodel.py)

def test_headline_dpa_throughput_gain():
    """Abstract: 2x FP16, 4x FP8, 8x FP4 throughput via DPA; Table I/II's
    2..16 GFLOP/s at 1 GHz."""
    for name, gain in (("fp16_dpa_fp32", 2), ("fp8_dpa_fp32", 4),
                       ("fp4_dpa_fp32", 8)):
        m = T.MODE_BY_NAME[name]
        assert T.gflops(m) / T.gflops(m, "fpnew") == gain, name
    expect = {"fp32_fma_scalar": 2, "fp16_fma_simd": 4, "fp16_dpa_fp32": 4,
              "fp8_fma_simd": 8, "fp8_dpa_fp32": 8, "fp4_dpa_fp32": 16}
    for name, gf in expect.items():
        assert T.gflops(T.MODE_BY_NAME[name]) == gf, name


def test_headline_area_and_efficiency():
    """+37.3 % area; 1.46x FP16 and 2.92x FP8 DPA area efficiency; the
    Fig. 7a ranges; merged-SIMD -9.44 %."""
    assert abs(A.TRANSDOT_AREA_RATIO_MEAN - 1.373) < 1e-9
    assert abs(T.area_efficiency(T.MODE_BY_NAME["fp16_dpa_fp32"]) - 1.46) \
        < 0.01
    assert abs(T.area_efficiency(T.MODE_BY_NAME["fp8_dpa_fp32"]) - 2.92) \
        < 0.01
    lo16, hi16 = T.area_efficiency_range(T.MODE_BY_NAME["fp16_dpa_fp32"])
    lo8, hi8 = T.area_efficiency_range(T.MODE_BY_NAME["fp8_dpa_fp32"])
    assert abs(lo16 - 1.28) < 0.01 and abs(hi16 - 1.52) < 0.01
    assert abs(hi8 - 3.04) < 0.01 and abs(lo8 - 2.55) < 0.01
    assert abs(A.MERGED_SIMD_AREA_RATIO - (1 - 0.0944)) < 1e-9


def test_headline_shifter_and_multilane_overheads():
    """10.7 % / 13.8 % reconfigurable-shifter overhead and 78.5 % / 75 %
    multi-lane cost at n = 128 / 64."""
    assert abs(A.reconfig_overhead(128) - 0.107) < 0.001
    assert abs(A.reconfig_overhead(64) - 0.138) < 0.001
    assert abs(A.multilane_overhead(128) - 0.785) < 0.005
    assert abs(A.multilane_overhead(64) - 0.750) < 0.001


def test_headline_energy_and_fig6():
    assert E.ENERGY_PJ_PER_FLOP["fp32_fma_scalar"] == 3.75
    assert abs(E.efficiency_vs_fp32("fp4_dpa_fp32") - 3.75 / 0.41) < 1e-9
    td = TM.multiplier_area(1.6, "transdot", pipelined=False)
    sep = TM.multiplier_area(1.6, "separated", pipelined=False)
    assert abs(1 - td / sep - 0.154) < 1e-6
    td = TM.multiplier_area(1.0, "transdot", pipelined=True)
    sep = TM.multiplier_area(1.0, "separated", pipelined=True)
    assert abs(1 - td / sep - 0.158) < 1e-6
    for d in (420, 500, 800):
        assert TM.shifter_area(d, "reconfig") == TM.shifter_area(d, "single")


# -----------------------------------------------------------------------------
# analytic census and model_flops against the reference
# -----------------------------------------------------------------------------

def test_shapes_grid_equals_the_reference():
    assert SHAPES == REF_SHAPES
    assert LONG_CTX_ARCHS == ("recurrentgemma-9b", "xlstm-1.3b")
    for arch in list_archs():
        for shape in SHAPES:
            assert cell_applicable(arch, shape) == ref_applicable(arch, shape)


CELLS = [(arch, shape, n) for arch in list_archs() for shape in SHAPES
         if cell_applicable(arch, shape) for n in (1, 256)]


@pytest.fixture(scope="module")
def ref_cells():
    out = {}
    for arch, shape, n in CELLS:
        cfg, sh = ref_config(arch), REF_SHAPES[shape]
        args = (cfg, sh["seq"], sh["batch"], sh["kind"])
        out[arch, shape, n] = (
            RAN.forward_macs(*args), RAN.cell_flops_per_device(*args, n),
            RAN.cell_hbm_bytes_per_device(*args, n),
            RH.model_flops(cfg, sh, sh["kind"]))
    return out


@pytest.mark.parametrize("arch,shape,n", CELLS)
def test_analytic_census_equals_the_reference(arch, shape, n, ref_cells):
    cfg, sh = get_config(arch), SHAPES[shape]
    args = (cfg, sh["seq"], sh["batch"], sh["kind"])
    got = (AN.forward_macs(*args), AN.cell_flops_per_device(*args, n),
           AN.cell_hbm_bytes_per_device(*args, n),
           R.model_flops(cfg, sh, sh["kind"]))
    assert got == ref_cells[arch, shape, n]


# -----------------------------------------------------------------------------
# the launch census against PERF.md's kernel table
# -----------------------------------------------------------------------------

QWEN = dict(wq=(2560, 4096), wk=(2560, 1024), wv=(2560, 1024),
            wo=(4096, 2560), wg=(2560, 9728), wu=(2560, 9728),
            wd=(9728, 2560))
GRANITE_ATTN = dict(wq=(1024, 1024), wk=(1024, 512), wv=(1024, 512),
                    wo=(1024, 1024))
GRANITE_EXPERT = ((1024, 512), (1024, 512), (512, 1024))
ENGINE_LENGTHS = (256, 201, 101, 18)
LONG_LENGTHS = (32768, 9001)


def _ms(works, peak=None):
    """Sum of the launches' bounds, ms (at `peak` where given)."""
    return sum(C.bound_s(w.bytes, w.ops, peak or w.peak) for w in works) \
        * 1e3


def _fused_layer(M, route, shapes=QWEN, E=1):
    kernel = "dpa_grouped_matmul_fused" if E > 1 else "dpa_matmul_fused"
    return [C.launch_work(kernel, route, E=E, M=M, K=K, N=N, x_bytes=2,
                          fmt_w="fp4_e2m1", pack_w=True)
            for K, N in (shapes.values() if isinstance(shapes, dict)
                         else shapes)]


def _prequant_layer(shapes, fmt, pack, E=1):
    kernel = "dpa_grouped_matmul_prequant" if E > 1 else \
        "dpa_matmul_prequant"
    return [C.launch_work(kernel, E=E, M=8, K=K, N=N, fmt_x=fmt, fmt_w=fmt,
                          pack_x=pack, pack_w=pack)
            for K, N in (shapes.values() if isinstance(shapes, dict)
                         else shapes)]


def _paged(H, hd, lengths, pages, fmt="fp8_e4m3", code_bytes=None, sq=1,
           k=0):
    """chip_smoke.py's paged cases: B requests, `pages` table entries a
    request; the verify fold (sq = k + 1) reads each row once and scores
    row i of request n over n - k + i keys."""
    B = len(lengths)
    pairs = sum(n - k + i for n in lengths for i in range(sq))
    return [C.launch_work("paged_decode_attention", fmt=fmt, B=B, sq=sq,
                          H=H, KV=8, hd=hd,
                          code_bytes=code_bytes or hd // 2, q_bytes=2,
                          table_entries=B * pages, kv_rows=sum(lengths),
                          pairs=pairs)]


def _flash(hd, H, KV, elem, window=None, dpa=True):
    kw = dict(B=1, H=H, KV=KV, sq=4096, sk=4096, hd=hd, causal=True,
              window=window)
    if dpa:
        return [C.launch_work("dpa_flash_attention", q_bytes=2,
                              kv_row_bytes=hd * 2, **kw)]
    return [C.launch_work("flash_attention", elem=elem, **kw)]


def _ops_at(works, peak, scale=1.0):
    return [C.Work(w.bytes, int(w.ops * scale), peak) for w in works]


FP16 = C.PEAK_OPS["fp16"]
PINS = {
    "1a qwen3-4b decode layer": (lambda: _ms(_fused_layer(8, "splitk")),
                                 "0.01552"),
    "1a granite attention layer": (
        lambda: _ms(_fused_layer(8, "splitk", GRANITE_ATTN)), "0.00052"),
    "1b qwen3-4b layer M 4096 fp8": (
        lambda: _ms(_fused_layer(4096, "tiled")), "0.4194"),
    "1b qwen3-4b layer M 4096 fp16": (
        lambda: _ms(_fused_layer(4096, "tiled"), FP16), "0.8360"),
    "1b pre-pass": (lambda: _ms([C.launch_work(
        "dpa_act_quant", rows=4096, K=K, x_bytes=2)
        for K, _ in QWEN.values()]), "0.0987"),
    "2 hd 128": (lambda: _ms(_paged(32, 128, ENGINE_LENGTHS, 16)),
                 "0.00021"),
    "2 hd 64": (lambda: _ms(_paged(16, 64, ENGINE_LENGTHS, 16)), "0.00010"),
    "2 hd 128 E4M3 KV": (lambda: _ms(_paged(32, 128, ENGINE_LENGTHS, 16,
                                            code_bytes=128)), "0.00038"),
    "2 hd 64 E4M3 KV": (lambda: _ms(_paged(16, 64, ENGINE_LENGTHS, 16,
                                           code_bytes=64)), "0.00019"),
    # the chip log prints the fold's bound to six places (PERF.md's
    # 0.00029 was that figure rounded again)
    "2 fold hd 128": (lambda: _ms(_paged(32, 128, ENGINE_LENGTHS, 16, sq=5,
                                         k=4)), "0.000285"),
    "2 fold hd 64": (lambda: _ms(_paged(16, 64, ENGINE_LENGTHS, 16, sq=5,
                                        k=4)), "0.000124"),
    "2 long hd 128": (lambda: _ms(_paged(32, 128, LONG_LENGTHS, 2048)),
                      "0.01358"),
    "2 long hd 64": (lambda: _ms(_paged(16, 64, LONG_LENGTHS, 2048)),
                     "0.00719"),
    "3 packed E2M1": (lambda: _ms(_prequant_layer(GRANITE_ATTN, "fp4_e2m1",
                                                  True)), "0.00051"),
    "3 fp16": (lambda: _ms(_prequant_layer(GRANITE_ATTN, "fp16", False)),
               "0.00193"),
    "3 bf16": (lambda: _ms(_prequant_layer(GRANITE_ATTN, "bf16", False)),
               "0.00193"),
    "3 E4M3": (lambda: _ms(_prequant_layer(GRANITE_ATTN, "fp8_e4m3",
                                           False)), "0.00098"),
    "3 unpacked E2M1": (lambda: _ms(_prequant_layer(
        GRANITE_ATTN, "fp4_e2m1", False)), "0.00098"),
    "4 hd 128": (lambda: _ms(_flash(128, 32, 8, 2)), "0.06947"),
    "4 hd 128 fp16": (lambda: _ms(_flash(128, 32, 8, 2), FP16), "0.1390"),
    "4 hd 128 fp16 PV twice": (
        lambda: _ms(_ops_at(_flash(128, 32, 8, 2), FP16, 1.5)), "0.2085"),
    "4 hd 256 window 2048": (lambda: _ms(_flash(256, 16, 1, 2, 2048)),
                             "0.05209"),
    "4 hd 256 fp16": (lambda: _ms(_flash(256, 16, 1, 2, 2048), FP16),
                      "0.1042"),
    "5 bf16": (lambda: _ms(_flash(128, 32, 8, 2, dpa=False)), "0.4170"),
    "5 f32": (lambda: _ms(_flash(128, 32, 8, 4, dpa=False)), "0.8340"),
    "5 f32 at the f32 peak": (lambda: _ms(_ops_at(
        _flash(128, 32, 8, 4, dpa=False), C.PEAK_OPS["fp32"], 1 / 6)),
        "2.0518"),
    "6 4096 x 9728": (lambda: _ms([C.launch_work(
        "quantize_rows", M=4096, K=9728, x_bytes=2, fmt="fp8_e4m3")]),
        "0.03569"),
    "6 32768 x 128": (lambda: _ms([C.launch_work(
        "quantize_rows", M=32768, K=128, x_bytes=2, fmt="fp8_e4m3")]),
        "0.00380"),
    "7 4096 x 9728": (lambda: _ms([C.launch_work(
        "quantize_pack_rows", M=4096, K=9728, x_bytes=2)]), "0.02974"),
    "7 32768 x 128": (lambda: _ms([C.launch_work(
        "quantize_pack_rows", M=32768, K=128, x_bytes=2)]), "0.00317"),
    "8 granite decode layer": (lambda: _ms(_fused_layer(
        8, "splitk", GRANITE_EXPERT, E=32)), "0.00861"),
    "9 packed E2M1": (lambda: _ms(_prequant_layer(
        GRANITE_EXPERT, "fp4_e2m1", True, E=32)), "0.00832"),
    "9 fp16": (lambda: _ms(_prequant_layer(GRANITE_EXPERT, "fp16", False,
                                           E=32)), "0.03115"),
    "9 E4M3": (lambda: _ms(_prequant_layer(GRANITE_EXPERT, "fp8_e4m3",
                                           False, E=32)), "0.01593"),
    "9 unpacked E2M1": (lambda: _ms(_prequant_layer(
        GRANITE_EXPERT, "fp4_e2m1", False, E=32)), "0.01593"),
}


def test_census_prices_the_new_formats():
    """One figure a format the kernels took last, by hand: the
    fused matmul's bytes at E2M1 and fp16 activations (x read raw, codes
    never stored) with operations at the operand format's peak, the
    pre-pass's fp16 codes, paged decode over 2-byte and unpacked codes
    with f32 attention bound by bytes, and DPA flash at fp16 and E2M1."""
    hbm = 3.35e12
    # qwen3-4b's wq (K 2560, N 4096) at M 4096, packed-E2M1 weights
    M, K, N = 4096, 2560, 4096
    nbytes = M * K * 2 + K * N // 2 + N * 4 + M * N * 4
    ops = 2 * M * K * N
    for fmt, peak in (("fp4_e2m1", 1979e12), ("fp16", 989e12)):
        w = C.launch_work("dpa_matmul_fused", "tiled", E=1, M=M, K=K, N=N,
                          x_bytes=2, fmt_w="fp4_e2m1", pack_w=True,
                          fmt_x=fmt)
        assert (w.bytes, w.ops, w.peak) == (nbytes, ops, peak)
        assert C.bound_s(*w) == max(nbytes / hbm, ops / peak)
    # the pre-pass at fp16: bf16 in, fp16 codes and one scale a block out
    w = C.launch_work("dpa_act_quant", rows=M, K=K, x_bytes=2, fmt="fp16")
    assert w.bytes == M * K * (2 + 2) + M * (K // 128) * 4 and w.ops == 0
    # paged decode, qwen3-4b's engine step (B 4, H 32, KV 8, hd 128, 16
    # pages a request): fp16 codes (256 bytes a row) under fp16 attention
    # on bf16 q, unpacked E2M1 (128) under f32 attention on f32 q
    rows, pairs = sum(ENGINE_LENGTHS), sum(ENGINE_LENGTHS)
    for fmt, code_bytes, q_bytes in (("fp16", 256, 2), ("fp32", 128, 4)):
        w = C.launch_work("paged_decode_attention", fmt=fmt, B=4, sq=1,
                          H=32, KV=8, hd=128, code_bytes=code_bytes,
                          q_bytes=q_bytes, table_entries=64, kv_rows=rows,
                          pairs=pairs)
        want = 2 * rows * 8 * (code_bytes + 4) \
            + 2 * 4 * 32 * 128 * q_bytes + 64 * 4 + 4 * 4
        assert (w.bytes, w.ops) == (want, 4 * pairs * 32 * 128)
        assert C.bound_by(*w) == "bytes"
    assert f"{C.bound_s(*w) * 1e3:.6f}" == "0.000402"
    # DPA flash, one qwen3-4b scoring layer: 2.75e11 operations at the
    # fp16 peak, and at fp8's for E2M1
    pairs = 4096 * 4097 // 2
    for fmt, peak in (("fp16", 989e12), ("fp4_e2m1", 1979e12)):
        w = C.launch_work("dpa_flash_attention", B=1, H=32, KV=8, sq=4096,
                          sk=4096, hd=128, q_bytes=2, kv_row_bytes=256,
                          causal=True, window=None, fmt=fmt)
        assert w.ops == 4 * 32 * 128 * pairs and w.peak == peak
        assert C.bound_s(*w) == w.ops / peak


@pytest.mark.parametrize("row", list(PINS))
def test_census_gives_the_kernel_table_bound(row):
    fn, printed = PINS[row]
    digits = len(printed.split(".")[1])
    assert f"{fn():.{digits}f}" == printed


def test_a_layer_bound_is_the_sum_of_its_launch_maxima():
    """One qwen3-4b layer on the tiled route at M 4,096: wk and wv wait on
    memory (0.01166 ms against 0.01085 by operations), so the sum of the
    seven maxima (0.4194) exceeds the bound of the summed totals
    (0.4178)."""
    works = _fused_layer(4096, "tiled")
    wk = works[list(QWEN).index("wk")]
    assert f"{wk.bytes / C.HBM_BYTES_PER_S * 1e3:.5f}" == "0.01166"
    assert f"{wk.ops / wk.peak * 1e3:.5f}" == "0.01085"
    assert C.bound_by(*wk) == "bytes"
    total = C.bound_s(sum(w.bytes for w in works), sum(w.ops for w in works),
                      C.PEAK_OPS["fp8_e4m3"]) * 1e3
    assert f"{total:.4f}" == "0.4178"
    assert f"{_ms(works):.4f}" == "0.4194"


def test_band_pairs_under_the_masks():
    assert C.attn_pairs(4096, 4096, True, 2048) == 6_292_480
    assert C.attn_pairs(4096, 4096) == 4096 * 4097 // 2
    assert C.attn_pairs(1500, 1500, False) == 1500 ** 2
    assert C.attn_pairs(32, 1500, False) == 32 * 1500
    # a query block behind a longer key range (query i at key i + 4)
    assert C.attn_pairs(4, 8, True) == 5 + 6 + 7 + 8
    assert C.attn_pairs(4, 8, True, 2) == 8


def test_linear_census_equals_the_analytic_count():
    """What chip_smoke.py checks on paths D and K: the tiled route's
    operations over one scoring pass equal 2 tokens layers (proj + mlp)
    of the analytic census, as integers."""
    smoke = _chip_smoke()
    for arch, S in (("qwen3-4b", 4096), ("pixtral-12b", 4096)):
        cfg = get_config(arch)
        hd, d = cfg.hd, cfg.d_model
        shapes = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
                  (d, cfg.n_kv_heads * hd), (cfg.n_heads * hd, d),
                  (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
        ops = cfg.n_layers * sum(C.launch_work(
            "dpa_matmul_fused", "tiled", E=1, M=S, K=K, N=N, x_bytes=2,
            fmt_w="fp4_e2m1", pack_w=True).ops for K, N in shapes)
        delta = {"dpa_matmul_fused.tiled:ops": ops}
        assert smoke.check_linear_census(arch, delta, cfg, S) == ops
        delta["dpa_matmul_fused.tiled:ops"] = ops - 2
        with pytest.raises(AssertionError, match="analytic"):
            smoke.check_linear_census(arch, delta, cfg, S)


# -----------------------------------------------------------------------------
# counters carry the work; route tables; the CLI
# -----------------------------------------------------------------------------

def _stub():
    def stub(route):
        C.count(stub, C.launch_work("quantize_pack_rows", M=64, K=128,
                                    x_bytes=2), route)
    C.declare(stub, "a", "b")
    return stub


def test_counters_carry_work_through_capture_and_replay():
    stub = _stub()
    wrappers = {"stub": stub}
    one = C.launch_work("quantize_pack_rows", M=64, K=128, x_bytes=2)
    stub("a")                                       # a warm-up launch
    before = counters.snapshot(wrappers)
    stub("a")
    stub("b")                                       # captured: two launches
    delta = counters.diff(counters.snapshot(wrappers), before)
    assert counters.launches(delta) == {"stub": 2, "stub.a": 1, "stub.b": 1}
    assert delta["stub:bytes"] == 2 * one.bytes and delta["stub:ops"] == 0
    assert delta["stub.b:bound_s"] == C.bound_s(*one)
    counters.add(delta, -1, wrappers)               # a capture launches none
    assert counters.snapshot(wrappers) == before
    for _ in range(5):                              # five replays
        counters.add(delta, wrappers=wrappers)
    snap = counters.snapshot(wrappers)
    assert snap["stub"] == 11 and snap["stub.a"] == 6
    assert snap["stub:bytes"] == 11 * one.bytes
    assert snap["stub.b:bytes"] == 5 * one.bytes
    assert snap["stub:bound_s"] == pytest.approx(11 * C.bound_s(*one),
                                                 rel=1e-12)
    counters.zero(wrappers)
    assert set(counters.snapshot(wrappers).values()) == {0}


def test_route_table_ranks_routes_by_loss():
    delta = {"x.a": 2, "x.a:bound_s": 2e-3, "x.a:bytes": 10, "x.a:ops": 4,
             "y": 1, "y:bound_s": 1e-3, "z": 3, "z:bound_s": 3e-6, "w": 0}
    rows = R.route_table(delta, {"x.a + w": 5.0, "y": 1.5, "z": None,
                                 "w": 1.0})
    assert [r["route"] for r in rows] == ["x.a + w", "y", "z"]
    a, y, z = rows
    assert (a["launches"], a["bytes"], a["ops"]) == (2, 10, 4)
    assert a["bound_ms"] == pytest.approx(2.0)
    assert a["loss_ms"] == pytest.approx(3.0)
    assert a["ratio"] == pytest.approx(2.5)
    assert y["loss_ms"] == pytest.approx(0.5)
    assert z["device_ms"] is None and z["loss_ms"] is None


def test_route_floor_check_refuses_an_impossible_reading():
    smoke = _chip_smoke()
    rows = [dict(route="r", launches=3, bound_ms=1.0, device_ms=0.96),
            dict(route="s", launches=1, bound_ms=1.0, device_ms=None)]
    smoke.check_route_floor("path", rows)        # 0.96 >= 1 / 1.05
    rows[0]["device_ms"] = 0.94
    with pytest.raises(AssertionError, match="below"):
        smoke.check_route_floor("path", rows)


def test_cell_roofline_sizes_the_scoring_paths():
    """The shares of the bound that later speed work moves: analytic
    FLOPs of a 4,096-token forward and its compute bound at the fp8 peak
    and at bf16 (qwen3-4b, pixtral-12b, recurrentgemma-9b)."""
    for arch, flops, fp8_ms, bf16_ms in (
            ("qwen3-4b", "3.790e+13", "19.2", "38.3"),
            ("pixtral-12b", "1.003e+14", "50.7", "101.4"),
            ("recurrentgemma-9b", "7.505e+13", "37.9", "75.9")):
        cfg = get_config(arch).replace(policy="w4a8_kv4_attn8")
        r = R.cell_roofline(cfg, "prefill", 4096, 1)
        assert f"{r['flops']:.3e}" == flops
        assert f"{r['compute_dpa_s'] * 1e3:.1f}" == fp8_ms
        assert f"{r['compute_s'] * 1e3:.1f}" == bf16_ms
        assert r["dominant"] == "compute" and r["dpa_fmt"] == "fp8_e4m3"
        assert r["bound_s"] == max(r["compute_dpa_s"], r["memory_s"])
    off = R.cell_roofline(get_config("qwen3-4b").replace(policy="fp32"),
                          "decode", 4096, 4)
    assert off["dpa_fmt"] == "fp32"
    assert off["compute_dpa_s"] == off["flops"] / C.PEAK_OPS["fp32"]


WIRE_POLICIES = ("w4a8_kv4_attn8", "kv4_attn8_packed", "kv8_attn_f32",
                 "attn_fp16_dpa")


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("policy", WIRE_POLICIES)
def test_wire_census_prices_the_sharded_routes(policy, n):
    """The census's pool all-gather = the sharded routes' wire term in the
    port's registry and the reference's (`_tp_wire_bytes`), at the
    engine geometry of chip_smoke's TP phase."""
    from repro.core.policy import get_policy as ref_policy
    from repro.kernels import registry as RREG

    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import registry as TREG
    pol = get_policy(policy)
    ctx = dict(n_devices=n, n_pages=80, page_size=16, kv_heads=8, hd=128)
    got = C.pool_gather_work(n, 80 * 16 * 8, 128, pol.fmt_kv, pol.kv_packed)
    assert got == TREG._tp_wire_bytes(pol, ctx) \
        == RREG._tp_wire_bytes(ref_policy(policy), ctx) > 0
    assert C.pool_gather_work(1, 80 * 16 * 8, 128, pol.fmt_kv,
                              pol.kv_packed) == 0
    assert C.wire_bound_s(got) == got / C.LINK_BYTES_PER_S


@pytest.mark.parametrize("arch,shape,n", CELLS)
def test_roofline_collective_term(arch, shape, n):
    """The wire term: zero on one card and off decode; a kv-quantized
    decode cell all-gathers every full attention layer's pool (B x S x KV
    rows at format width), a raw-cache one sums flash decoding's f32
    partials; the collective term is those bytes at the NVLink rate and
    joins the bound."""
    cfg, sh = get_config(arch), SHAPES[shape]
    for policy in (cfg.policy, "w4a8_kv4_attn8"):
        c = cfg.replace(policy=policy)
        r = R.cell_roofline(c, sh["kind"], sh["seq"], sh["batch"], n)
        wire = AN.cell_wire_bytes_per_device(c, sh["seq"], sh["batch"],
                                             sh["kind"], n)
        assert r["wire_bytes"] == wire
        assert r["collective_s"] == wire / C.LINK_BYTES_PER_S
        assert r["bound_s"] == max(r["compute_dpa_s"], r["memory_s"],
                                   r["collective_s"])
        if n == 1 or sh["kind"] != "decode":
            assert wire == 0.0
            continue
        n_attn = sum(m for k, m in AN._pattern_counts(c).items()
                     if k in ("attn", "dec"))
        pol = get_policy(policy)
        want = (n_attn * C.pool_gather_work(
            n, sh["batch"] * sh["seq"] * c.n_kv_heads, c.hd, pol.fmt_kv,
            pol.kv_packed) if pol.kv_quantized else
            n_attn * (n - 1) * sh["batch"] * c.n_heads * (2 + c.hd) * 4.0)
        assert wire == want and (wire > 0) == (n_attn > 0)


def test_roofline_cli_runs_without_jax():
    script = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.argv = ['roofline', '--arch', 'qwen3-4b', '--shape', "
        "'prefill_32k']\n"
        "runpy.run_module('repro_torch.launch.roofline', "
        "run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    cfg, sh = get_config("qwen3-4b"), SHAPES["prefill_32k"]
    r = R.cell_roofline(cfg, sh["kind"], sh["seq"], sh["batch"])
    assert (f"| qwen3-4b | prefill_32k | **{r['dominant']}** | "
            f"{r['compute_s']:.3e} | {r['compute_dpa_s']:.3e} | "
            f"{r['memory_s']:.3e} | fp8_e4m3 |") in out.stdout
    assert out.stdout.count("| qwen3-4b |") == 1


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
