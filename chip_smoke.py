"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (every failure raises; the exit code is then non-zero):

1. Card: name and power limit, torch and CUDA versions, and the build of
   the CUDA kernels from `src/repro_torch/csrc/` (timed).
2. Kernels against their plain PyTorch versions on the card, at the
   serving paths' shapes:
   - `dpa_matmul_fused` at every projection of qwen3-4b and at the
     attention projections of granite-moe-1b (M = 4 decode, M = 32
     prefill chunk);
   - `paged_decode_attention` at the engine's decode geometry plus the
     block-table edge cases (odd lengths, mid-page positions, an idle
     slot on the scratch page), for qwen3-4b (hd 128, H 32, KV 8) and
     granite-moe-1b (hd 64, H 16, KV 8);
   - `dpa_grouped_matmul_fused` at granite's expert shapes (E 32, K x N
     1024 x 512 and 512 x 1024) for M = 8 (decode, 4 rows padded) and
     M = 11 (a 32-token prefill chunk's capacity), with capacity-dropped
     zero rows, which must come out exactly 0;
   - `dpa_matmul_prequant` at granite's attention projections and
     `dpa_grouped_matmul_prequant` at its expert shapes, held to
     `max_abs_err == 0` (fp4 x fp4 sums are exact in f32).
   Each kernel, its plain version and (for the prequant pair)
   `torch._scaled_mm` / `torch._scaled_grouped_mm` on the e4m3-widened
   codes are timed two ways: `ms` / `plain_ms` / `library_ms`, the median
   of 25 CUDA-event-bracketed calls (which includes the host's launch
   time), and `device_ms` / `plain_device_ms` / `library_device_ms`, the
   profiler's device time per call over 20 calls; beside them the least
   time the card could take (bytes over 3.35 TB/s, or operations over the
   fp8 peak, whichever is larger).
3. Serving at full width, seeded random weights, policy w4a8_kv4_attn8
   unless said otherwise; the kernel launch counters are zeroed just
   before each path and read just after:
   a. qwen3-4b (36 layers) serves 8 synthetic requests through the
      continuous-batching engine: every projection through the fused
      kernel, every decode step's attention through the paged kernel;
   b. granite-moe-1b-a400m (24 layers, 32 experts top-8) serves 8
      synthetic requests through the engine: attention projections
      through the fused kernel, expert matmuls through the grouped fused
      kernel, decode attention through the paged kernel (hd 64); and
      its first layer's `apply_moe` runs three times on one bf16 input,
      which must give the same bits each time;
   c. granite-moe-1b under fp4_dpa_packed through `generate` (2 prompts
      of 32 tokens, 16 new): attention projections through the dense
      prequant kernel, experts through the grouped prequant kernel,
      attention in f32 over a raw bf16 cache.
   The expected counts are computed from the config and the run.
4. Where the time goes: torch.profiler over one steady decode step and
   one prefill chunk of each engine (device busy share, top kernels).

Prints the engine reports and the profiles as JSON, the kernels' JSON
line, the card's name and power limit, and, as the last line,
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or without the
repository's sources.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (data sheet)
FP8_OPS_PER_S = 1979e12           # H100 SXM dense fp8 tensor-core peak
MATMUL_RTOL, MATMUL_ATOL = 2e-5, 2e-4   # the reference's fused-route pin


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, n: int = 25) -> float:
    """Median CUDA-event time of fn over n runs after 3 warm-ups."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(fn, n: int = 20):
    """Device time of fn per call: the durations of the device activities
    (kernels, copies, fills) of n calls under torch.profiler, summed and
    divided by n, after warm-up.  Unlike `median_ms`, which brackets one
    call with CUDA events, it counts no device idle time while the host
    prepares a launch — at these sizes that host time is most of a call.

    None (not measured) when two sessions, half a second apart, return no
    device records: short sessions sometimes do, for a stretch of several
    sessions, and later ones record again.  The event-timed `median_ms`
    does not depend on the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / n
    return None


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


TIME_KEYS = ("ms", "plain_ms", "device_ms", "plain_device_ms")


def timings(kernel, plain) -> dict:
    """A kernel's and its plain version's time per call, each both ways:
    `ms` / `plain_ms` the median CUDA-event time of one call (host launch
    time included), `device_ms` / `plain_device_ms` the profiler's device
    time per call."""
    return {"ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain)}


def fmt_times(t: dict) -> str:
    def dev(v, digits):
        return "not measured" if v is None else f"{v:.{digits}f}"
    return (f"kernel_ms {t['ms']:.4f} (device {dev(t['device_ms'], 4)}) "
            f"plain_ms {t['plain_ms']:.3f} (device "
            f"{dev(t['plain_device_ms'], 3)})")


# -----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# -----------------------------------------------------------------------------

def check_matmul(cfg, gen, projections):
    """Every (K, N) of `projections` (name -> (K, N), the dense
    projections one layer of the model runs through this kernel) at M = 4
    (the engine's decode step) and 32 (a prefill chunk), bf16 x,
    packed-fp4 weights prepared as the model prepares them (and the
    kernel's (fp8, fp8) pair at M = 32, untimed)."""
    import torch
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import (dpa_matmul_fused_pipeline,
                                         prep_weights)
    shapes = sorted(set(projections.values()))
    worst = 0.0
    timed = {}
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_weights(w.to(torch.bfloat16), cfg.policy)
        for M in (4, 32):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            # the kernel's own inputs: the pipeline's padding of M
            xp = torch.nn.functional.pad(x, (0, 0, 0, max(8, M) - M))
            args = (xp, prep["wq"], prep["sw"])
            kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
            got = DM.dpa_matmul_fused(*args, **kw)
            want = DM.dpa_matmul_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all())
            worst = max(worst, float(err.max()))
            # and through the pipeline the model calls (pads, slices, casts)
            pipe = dpa_matmul_fused_pipeline(x, prep, cfg.policy)
            if pipe.shape != (M, N) or pipe.dtype != torch.bfloat16:
                raise AssertionError(f"pipeline gave {pipe.dtype} "
                                     f"{tuple(pipe.shape)}")
            if not ok:
                raise AssertionError(
                    f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M}: max err "
                    f"{float(err.max())} over rtol {MATMUL_RTOL} / atol "
                    f"{MATMUL_ATOL}")
            t = timings(lambda: DM.dpa_matmul_fused(*args, **kw),
                        lambda: DM.dpa_matmul_fused_ref(*args, **kw))
            nbytes = (xp.numel() * 2 + prep["wq"].numel()
                      + prep["sw"].numel() * 4 + xp.shape[0] * N * 4)
            t["bound_ms"], b_by = bound(nbytes, 2.0 * xp.shape[0] * K * N)
            timed[(K, N, M)] = t
            print(f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M}: "
                  f"max_abs_err {float(err.max()):.3g} {fmt_times(t)} "
                  f"bound_ms {t['bound_ms']:.5f} ({b_by})")
        # the kernel's other fmt pair, (fp8, fp8) weights: checked, untimed
        prep8 = prep_weights(w.to(torch.bfloat16), "fp8_dpa_fused")
        args = (xp, prep8["wq"], prep8["sw"])
        kw = dict(fmt_x="fp8_e4m3", fmt_w="fp8_e4m3", pack_w=False)
        got = DM.dpa_matmul_fused(*args, **kw)
        want = DM.dpa_matmul_fused_ref(*args, **kw)
        err = (got - want).abs()
        if not bool((err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all()):
            raise AssertionError(f"dpa_matmul_fused {cfg.name} fp8 weights "
                                 f"K={K} N={N}: max err {float(err.max())}")
        worst = max(worst, float(err.max()))
        print(f"dpa_matmul_fused {cfg.name} K={K} N={N} M=32 fp8 weights: "
              f"max_abs_err {float(err.max()):.3g}")
    per_layer = _per_layer(timed, projections, 4)
    print(f"dpa_matmul_fused {cfg.name}: {len(projections)} launches per "
          f"layer per model call, {len(projections) * cfg.n_layers} per "
          f"decode step; one decode layer (M=4): {fmt_times(per_layer)}, "
          f"bound {per_layer['bound_ms']:.5f} ms")
    return worst, per_layer


def _paged_case(cfg, pol, gen, lengths, page, positions=None):
    """A paged cache holding `lengths` rows per request (relaid out from a
    contiguous one), queries at `positions` (default: the last row)."""
    import torch
    from repro_torch.core import kvcache as KV
    B = len(lengths)
    S = max(-(-n // page) for n in lengths) * page
    k = torch.randn((B, S, cfg.n_kv_heads, cfg.hd), generator=gen,
                    device="cuda")
    v = torch.randn((B, S, cfg.n_kv_heads, cfg.hd), generator=gen,
                    device="cuda")
    ref = KV.update_kv_cache(
        KV.init_kv_cache(B, S, cfg.n_kv_heads, cfg.hd, fmt=pol.fmt_kv,
                         packed=pol.kv_packed, device="cuda"),
        k, v, 0, fmt=pol.fmt_kv, packed=pol.kv_packed)
    cache = KV.paged_from_contiguous(ref, lengths, page_size=page)
    pos = positions if positions is not None else [n - 1 for n in lengths]
    q = torch.randn((B, 1, cfg.n_heads, cfg.hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    return q, cache, torch.tensor(pos, dtype=torch.int32, device="cuda")


def check_paged(cfg, pol, gen, ecfg):
    """The kernel against the gather + dpa_attention plain version.

    The two sum in different orders, so logits differ in the last f32
    bits, exp then differs by ulps, and a probability code can flip to its
    E4M3 neighbour where p / psq sits at a rounding midpoint.  The pin
    (`PAGED_DECODE_CARD_TOL`, 2e-2 absolute) admits such a flip where its
    weight is small against the denominator, and catches a wrong row,
    page or mask, which moves outputs by O(1)."""
    import torch
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.registry import PAGED_DECODE_CARD_TOL as TOL
    kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, kv_packed=pol.kv_packed)

    def compare(name, q, cache, pos):
        args = (q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
                cache["v_scale"], cache["block_table"], pos)
        got = PD.paged_decode_attention(*args, **kw)
        want = PD.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or float(err.max()) > TOL:
            raise AssertionError(f"paged_decode_attention {name}: max err "
                                 f"{float(err.max())} > {TOL}")
        print(f"paged_decode_attention hd={cfg.hd} {name}: max_abs_err "
              f"{float(err.max()):.3g}, {int((err > 0).sum())} of "
              f"{err.numel()} outputs differ")
        return float(err.max()), args

    worst = 0.0
    # the engine's decode geometry: B = max_batch, full block tables
    lengths = [256, 201, 101, 18]
    q, cache, pos = _paged_case(cfg, pol, gen, lengths, ecfg.page_size)
    e, main_args = compare("B=4 page=16 lengths [256,201,101,18]", q, cache,
                           pos)
    worst = max(worst, e)
    # edge cases: partial tail pages at page 8, mid-page positions, and an
    # idle slot whose table row is all scratch
    q, cache, pos = _paged_case(cfg, pol, gen, [13, 5, 17], 8)
    worst = max(worst, compare("lengths [13,5,17] page=8", q, cache, pos)[0])
    for p in ([0, 16], [7, 8], [15, 3]):
        q, cache, pos = _paged_case(cfg, pol, gen, [17, 17], 8, p)
        worst = max(worst, compare(f"mid-page positions {p}", q, cache,
                                   pos)[0])
    q, cache, pos = _paged_case(cfg, pol, gen, [13, 9, 1], 8, [12, 8, 0])
    cache["block_table"][2] = 0                    # idle slot -> scratch
    worst = max(worst, compare("idle slot on the scratch page", q, cache,
                               pos)[0])

    t = timings(lambda: PD.paged_decode_attention(*main_args, **kw),
                lambda: PD.paged_decode_attention_ref(*main_args, **kw))
    q, table, pos = main_args[0], main_args[5], main_args[6]
    live_rows = sum(lengths) * cfg.n_kv_heads
    row_bytes = cfg.hd // 2 + 4                   # packed codes + scale
    # K and V live rows once, q read and out written (bf16), table, pos
    nbytes = (2 * live_rows * row_bytes + 2 * q.numel() * 2
              + table.numel() * 4 + pos.numel() * 4)
    ops = 2 * 2 * sum(lengths) * cfg.n_heads * cfg.hd
    t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
    print(f"paged_decode_attention hd={cfg.hd} B=4: {fmt_times(t)} bound_ms "
          f"{t['bound_ms']:.6f} ({t['bound_by']}); 1 launch per layer, "
          f"{cfg.n_layers} per decode step")
    return worst, t


def _expert_shapes(cfg):
    """(K, N) of the expert matrices per decode layer: wg, wu, wd."""
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": (d, f), "wu": (d, f), "wd": (f, d)}


def _dense_shapes(cfg):
    """(K, N) of the projections one layer runs through the dense fused
    kernel: attention, and the MLP of a dense model."""
    return _attn_shapes(cfg) if cfg.is_moe else {
        **_attn_shapes(cfg), "wg": (cfg.d_model, cfg.d_ff),
        "wu": (cfg.d_model, cfg.d_ff), "wd": (cfg.d_ff, cfg.d_model)}


def _attn_shapes(cfg):
    d, q_out, kv_out = cfg.d_model, cfg.n_heads * cfg.hd, \
        cfg.n_kv_heads * cfg.hd
    return {"wq": (d, q_out), "wk": (d, kv_out), "wv": (d, kv_out),
            "wo": (q_out, d)}


def _drop(x, live):
    """Zero the rows of each expert past its live count: capacity slots no
    token filled, or whose assignment was dropped, hold zeros."""
    for e, n in enumerate(live):
        x[e, n:] = 0
    return x


def check_grouped_fused(cfg, gen):
    """The grouped fused kernel at the experts' shapes, bf16 x, packed-fp4
    expert weights prepared from the f32 masters as the model prepares
    them; M = 8 is the decode step (4 live rows, padded as the pipeline
    pads them), M = 11 a 32-token prefill chunk's capacity.  Zero rows
    must give exactly 0."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels.ops import prep_grouped_weights
    E = cfg.n_experts
    kw = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
    worst, timed = 0.0, {}
    for K, N in sorted(set(_expert_shapes(cfg).values())):
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_grouped_weights(w, cfg.policy)
        for M, live in ((8, [4] * (E - 2) + [1, 0]),
                        (11, [11] * (E - 3) + [7, 3, 0])):
            x = torch.randn((E, M, K), generator=gen, device="cuda")
            x = _drop(x, live).to(torch.bfloat16)
            args = (x, prep["wq"], prep["sw"])
            got = GM.dpa_grouped_matmul_fused(*args, **kw)
            want = GM.dpa_grouped_matmul_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            err = (got - want).abs()
            ok = bool((err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all())
            dropped = torch.cat([got[e, n:].reshape(-1)
                                 for e, n in enumerate(live)])
            if not ok or bool((dropped != 0).any()):
                raise AssertionError(
                    f"dpa_grouped_matmul_fused E={E} K={K} N={N} M={M}: max "
                    f"err {float(err.max())}, {int((dropped != 0).sum())} "
                    "nonzero outputs on dropped rows")
            worst = max(worst, float(err.max()))
            t = timings(lambda: GM.dpa_grouped_matmul_fused(*args, **kw),
                        lambda: GM.dpa_grouped_matmul_fused_ref(*args, **kw))
            nbytes = (x.numel() * 2 + prep["wq"].numel()
                      + prep["sw"].numel() * 4 + E * M * N * 4)
            t["bound_ms"], b_by = bound(nbytes, 2.0 * E * M * K * N)
            timed[(K, N, M)] = t
            print(f"dpa_grouped_matmul_fused E={E} K={K} N={N} M={M}: "
                  f"max_abs_err {float(err.max()):.3g}, {dropped.numel()} "
                  f"dropped-row outputs all 0; {fmt_times(t)} bound_ms "
                  f"{t['bound_ms']:.5f} ({b_by})")
    per_layer = _per_layer(timed, _expert_shapes(cfg), 8)
    print(f"dpa_grouped_matmul_fused: 3 launches per layer per model call; "
          f"one decode layer (M=8): {fmt_times(per_layer)}, bound "
          f"{per_layer['bound_ms']:.5f} ms")
    return worst, per_layer


def _per_layer(timed, shapes, M):
    """Sums of each time over one layer's matrices at M rows (None where
    one of them was not measured)."""
    out = {}
    for key in TIME_KEYS + ("bound_ms",):
        vals = [timed[(K, N, M)][key] for K, N in shapes.values()]
        out[key] = None if None in vals else sum(vals)
    return out


def _e4m3_operands(xq, wq):
    """Packed E2M1 codes widened onto e4m3 (exact: every E2M1 value is an
    e4m3 value), rows padded to 16 for the library's alignment, the
    weights column-major: the library's inputs for the same product."""
    import torch
    from repro_torch.kernels.dpa_matmul import widen
    x8 = widen(xq, "fp4_e2m1", packed=True, dim=-1)
    x8 = torch.nn.functional.pad(x8, (0, 0, 0, -x8.shape[-2] % 16))
    w8 = widen(wq, "fp4_e2m1", packed=True, dim=-2)
    w8 = w8.transpose(-1, -2).contiguous().transpose(-1, -2)
    return (x8.to(torch.float8_e4m3fn).contiguous(),
            w8.to(torch.float8_e4m3fn))


def library_prequant(xq, wq, sx, sw, want):
    """One PyTorch call computing the prequant product on the same codes
    and scales (`torch._scaled_mm`, or `torch._scaled_grouped_mm` for an
    expert stack; bf16 out, the only output rowwise scaling takes):
    -> (ms, device ms, max_abs_err vs the plain version, note), timed as
    `timings` times a kernel."""
    import torch
    grouped = xq.ndim == 3
    fn_name = "_scaled_grouped_mm" if grouped else "_scaled_mm"
    if not hasattr(torch, fn_name):
        return (None, None, None,
                f"none: torch {torch.__version__} has no {fn_name}")
    x8, w8 = _e4m3_operands(xq, wq)
    M = xq.shape[-2]
    sa = torch.nn.functional.pad(sx.reshape(*sx.shape[:-2], -1),
                                 (0, x8.shape[-2] - M))
    if grouped:
        sb = sw.reshape(sw.shape[0], -1).contiguous()
        call = lambda: torch._scaled_grouped_mm(  # noqa: E731
            x8, w8, sa.contiguous(), sb, out_dtype=torch.bfloat16)
    else:
        call = lambda: torch._scaled_mm(  # noqa: E731
            x8, w8, scale_a=sa.reshape(-1, 1).contiguous(),
            scale_b=sw.contiguous(), out_dtype=torch.bfloat16)
    try:
        out = call()
    except (RuntimeError, TypeError, ValueError) as e:   # a yardstick only
        return (None, None, None,
                f"none: torch.{fn_name} refused ({str(e)[:120]})")
    err = float((out[..., :M, :].float() - want).abs().max())
    return (median_ms(call), device_ms(call), err,
            f"torch.{fn_name}, bf16 out (outputs up to "
            f"{float(want.abs().max()):.4g})")


def check_prequant(cfg, gen):
    """The prequant kernels, dense at the attention projections and
    grouped at the experts, on random packed-fp4 codes with random
    positive scales: M = 8 is `generate`'s decode step (2 live rows,
    padded), M = 11 a prefill chunk's expert capacity.  Kernel and plain
    version must agree exactly."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    E = cfg.n_experts
    kw = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True, pack_w=True)

    def codes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.uint8)

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") + 0.05

    out = {}
    for what, shapes, lead in (("dense", _attn_shapes(cfg), ()),
                               ("grouped", _expert_shapes(cfg), (E,))):
        kern = DM.dpa_matmul_prequant if not lead else \
            GM.dpa_grouped_matmul_prequant
        ref = DM.dpa_matmul_prequant_ref if not lead else \
            GM.dpa_grouped_matmul_prequant_ref
        worst, timed, lib = 0.0, {}, {}
        for K, N in sorted(set(shapes.values())):
            wq, sw = codes(*lead, K // 2, N), scales(*lead, 1, N)
            for M in (8, 11):
                xq, sx = codes(*lead, M, K // 2), scales(*lead, M, 1)
                if lead:
                    xq = _drop(xq, [M // 2] * (E - 1) + [0])
                args = (xq, wq, sx, sw)
                got = kern(*args, **kw)
                want = ref(*args, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if err != 0.0 or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{kern.__name__} {lead} K={K} N={N}"
                                         f" M={M}: max err {err} != 0")
                worst = max(worst, err)
                t = timings(lambda: kern(*args, **kw),
                            lambda: ref(*args, **kw))
                n_e = E if lead else 1
                nbytes = (xq.numel() + sx.numel() * 4 + wq.numel()
                          + sw.numel() * 4 + n_e * M * N * 4)
                t["bound_ms"], b_by = bound(nbytes, 2.0 * n_e * M * K * N)
                timed[(K, N, M)] = t
                lib_ms, lib_dev, lib_err, note = library_prequant(*args, want)
                lib[(K, N, M)] = (lib_ms, lib_dev)
                print(f"{kern.__name__} {'E=%d ' % E if lead else ''}K={K} "
                      f"N={N} M={M}: max_abs_err {err:.3g}; {fmt_times(t)} "
                      f"bound_ms {t['bound_ms']:.5f} ({b_by}); library {note}"
                      + (f" {lib_ms:.4f} ms (device {lib_dev}), "
                         f"max_abs_err {lib_err:.3g}"
                         if lib_ms is not None else ""))
        per_layer = _per_layer(timed, shapes, 8)
        for i, key in enumerate(("library_ms", "library_device_ms")):
            libs = [lib[(K, N, 8)][i] for K, N in shapes.values()]
            per_layer[key] = None if None in libs else sum(libs)
        per_layer["max_abs_err"] = worst
        print(f"{kern.__name__}: {len(shapes)} launches per layer per model "
              f"call; one decode layer (M=8): {fmt_times(per_layer)}, bound "
              f"{per_layer['bound_ms']:.5f} ms, library "
              f"{per_layer['library_ms']} ms (device "
              f"{per_layer['library_device_ms']})")
        out[what] = per_layer
    return out


# -----------------------------------------------------------------------------
# phase 3: the engine at full width
# -----------------------------------------------------------------------------

def teacher_forced(model, params, req, s_ctx):
    """Step the static contiguous-cache path over the engine's own token
    timeline and compare its argmax with each engine token: where they
    differ, the static logits' top-1/top-2 margin says whether the two
    paths split a near-tie (numerics) or disagree outright (a fault)."""
    import numpy as np
    import torch
    toks = torch.from_numpy(req.tokens().astype(np.int64)).to("cuda")[None]
    n0 = req.n_prompt
    caches = model.init_caches(1, s_ctx)
    logits, caches = model.decode_step(
        params, {"tokens": toks[:, :n0], "index": 0}, caches)
    rows = [logits[0, -1]]
    for j in range(1, req.max_new):
        logits, caches = model.decode_step(
            params, {"tokens": toks[:, n0 + j - 1:n0 + j], "index": n0 + j - 1},
            caches)
        rows.append(logits[0, -1])
    lg = torch.stack(rows)
    top = torch.topk(lg, 2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]).cpu().numpy()
    agree = (lg.argmax(-1).cpu().numpy() == np.asarray(req.out_tokens))
    scale = float(lg.abs().max())
    worst = float(margin[~agree].max()) if (~agree).any() else 0.0
    print(f"request {req.rid}: teacher-forced agreement {int(agree.sum())}/"
          f"{req.max_new}; largest static top-2 margin where they differ "
          f"{worst:.3g} (median margin {float(np.median(margin)):.3g}, "
          f"logit scale {scale:.3g})")


KERNEL_NAMES = ("dpa_matmul_fused", "paged_decode_attention",
                "dpa_matmul_prequant", "dpa_grouped_matmul_fused",
                "dpa_grouped_matmul_prequant")


def _wrappers():
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels import paged_decode as PD
    return {"dpa_matmul_fused": DM.dpa_matmul_fused,
            "paged_decode_attention": PD.paged_decode_attention,
            "dpa_matmul_prequant": DM.dpa_matmul_prequant,
            "dpa_grouped_matmul_fused": GM.dpa_grouped_matmul_fused,
            "dpa_grouped_matmul_prequant": GM.dpa_grouped_matmul_prequant}


def zero_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def check_counts(what, got, want):
    """Every kernel's launches over one path equal the count its config
    and run imply (0 for the kernels the path does not run)."""
    want = {k: want.get(k, 0) for k in KERNEL_NAMES}
    if got != want:
        raise AssertionError(f"{what} launches {got}, want {want}")
    print(f"launches on the {what} path: " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))


def per_call_projections(cfg):
    """(dense projections, expert matmuls) one model call runs per layer."""
    return (4, 3) if cfg.is_moe else (7, 0)


def build(cfg):
    import torch
    from repro_torch.models import build_model
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"policy={cfg.policy} dtype={cfg.dtype}, init + weight prep "
          f"{time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    return model, params


def finite_steps(model):
    """Wrap model.decode_step to AND every call's logits' finiteness into
    one device flag; -> (flag holder, restore)."""
    import torch
    state = {"finite": torch.ones((), dtype=torch.bool, device="cuda")}
    step_fn = model.decode_step

    def checked_step(p, batch, caches):
        logits, caches = step_fn(p, batch, caches)
        state["finite"] = state["finite"] & torch.isfinite(logits).all()
        return logits, caches

    model.decode_step = checked_step

    def restore():
        model.decode_step = step_fn
        return bool(state["finite"])
    return restore


def moe_repeatable(params, cfg, runs: int = 3):
    """The first layer's `apply_moe` on a prefill chunk's worth of bf16
    tokens (4 x 32), run again and again: its dispatch scatter and its
    combine use no atomics, so every run must give the same bits."""
    import torch
    from repro_torch.models.layers import apply_moe
    mlp = params["layers"][0]["mlp"]
    x = torch.randn((4, 32, cfg.d_model), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3)
                    ).to(torch.bfloat16)
    first, _ = apply_moe(mlp, x, cfg)
    for _ in range(runs - 1):
        again, _ = apply_moe(mlp, x, cfg)
        if not torch.equal(first, again):
            raise AssertionError("apply_moe gave different bf16 outputs on "
                                 "two runs of the same input")
    if first.dtype != torch.bfloat16 or not bool(torch.isfinite(first).all()):
        raise AssertionError(f"apply_moe gave {first.dtype}, finite "
                             f"{bool(torch.isfinite(first).all())}")
    print(f"apply_moe {cfg.name} layer 0, bf16 x (4, 32, {cfg.d_model}): "
          f"{runs} runs bit-identical")


def run_engine(cfg, ecfg, *, agreement: bool):
    import numpy as np
    import torch
    from repro_torch.launch.engine import Engine, synthetic_workload
    from repro_torch.launch.serve import generate

    model, params = build(cfg)
    restore = finite_steps(model)
    reqs = synthetic_workload(8, vocab=cfg.vocab_size, seed=0, rate=0,
                              prompt_range=(64, 192), gen_range=(16, 32))
    engine = Engine(model, params, ecfg, device="cuda")
    zero_counts()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    counts = read_counts()
    finite = restore()

    for r in reqs:
        if r.n_generated != r.max_new:
            raise AssertionError(f"request {r.rid}: {r.n_generated} of "
                                 f"{r.max_new} tokens")
    if engine.alloc.in_use != 0 or np.any(engine._table != 0):
        raise AssertionError("pages not evicted / table not back to scratch")
    if not finite:
        raise AssertionError("non-finite logits")
    calls = rep["prefill_calls"] + rep["decode_steps"]
    dense, experts = per_call_projections(cfg)
    check_counts(f"{cfg.name} engine", counts, {
        "dpa_matmul_fused": dense * cfg.n_layers * calls,
        "dpa_grouped_matmul_fused": experts * cfg.n_layers * calls,
        "paged_decode_attention": cfg.n_layers * rep["decode_steps"]})
    print(f"  = {dense * cfg.n_layers} dense"
          + (f" + {experts * cfg.n_layers} grouped" if experts else "")
          + f" per model call x {calls} calls, {cfg.n_layers} paged per "
          f"decode step x {rep['decode_steps']} steps")
    if cfg.is_moe:
        moe_repeatable(params, cfg)
        want = {"moe_experts": cfg.n_experts, "moe_top_k": cfg.top_k,
                "moe_grouped_route": "cuda_grouped_fused",
                "moe_grouped_backend": "cuda",
                "expert_w_reduction_vs_f32": 8.0}
        bad = {k: rep.get(k) for k, v in want.items() if rep.get(k) != v}
        if bad or not rep.get("moe_grouped_bytes_per_step_layer"):
            raise AssertionError(f"moe report fields {bad}")
    print(f"engine: {cfg.name} {rep['n_requests']} requests, "
          f"{rep['gen_tokens']} tokens in {rep['wall_s']:.2f} s = "
          f"{rep['tokens_per_s']:.2f} tok/s; {rep['prefill_calls']} prefill "
          f"calls, {rep['decode_steps']} decode steps, {rep['steps']} ticks; "
          f"TTFT p50 {rep['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
          f"{rep['p50_latency_s'] * 1e3:.0f} ms p99 "
          f"{rep['p99_latency_s'] * 1e3:.0f} ms")
    print(f"kv-cache: peak live {rep['live_bytes'] / 1e6:.2f} MB "
          f"({rep['peak_live_tokens']} tokens) in {rep['paged_bytes'] / 1e6:.2f}"
          f" MB of pages vs static {rep['static_bytes'] / 1e6:.2f} MB / f32 "
          f"{rep['static_f32_bytes'] / 1e6:.2f} MB; decode route "
          f"{rep['decode_route']} [{rep['decode_backend']}]")
    if cfg.is_moe:
        print(f"moe: {rep['moe_experts']} experts top-{rep['moe_top_k']} via "
              f"{rep['moe_grouped_route']} [{rep['moe_grouped_backend']}]; "
              f"expert weights {rep['expert_w_bytes'] / 1e6:.2f} MB vs f32 "
              f"{rep['expert_w_bytes_f32'] / 1e6:.2f} MB "
              f"({rep['expert_w_reduction_vs_f32']:.1f}x)")

    # greedy agreement with the static path on the card (printed, not
    # asserted: the paged kernel and the contiguous plain path sum in
    # different orders, and random weights leave near-tied logits)
    for r in reqs[:2] if agreement else ():
        out = generate(model, params, r.prompt[None], r.max_new, ecfg.s_max,
                       device="cuda")
        same = np.asarray(r.out_tokens) == out[0, r.n_prompt:].cpu().numpy()
        first = int(np.argmin(same)) if not same.all() else r.max_new
        print(f"request {r.rid}: engine vs generate greedy agreement "
              f"{int(same.sum())}/{r.max_new}, identical up to token "
              f"{first}")
        teacher_forced(model, params, r, ecfg.s_max)
    return model, params, rep, counts


def run_generate(cfg, params, *, n_prompts=2, prompt_len=32, n_new=16):
    """Static greedy serving (`generate`) under cfg's policy, over params
    built for the same model (the weights prepared again for the policy):
    the launch counters over the run, finite logits, the output's shape
    and range."""
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = model.prepare_params(params)
    restore = finite_steps(model)
    prompt = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len),
                           generator=torch.Generator().manual_seed(2))
    s_ctx = prompt_len + n_new
    zero_counts()
    t0 = time.monotonic()
    out = generate(model, params, prompt, n_new, s_ctx, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    if not restore():
        raise AssertionError("non-finite logits")
    if tuple(out.shape) != (n_prompts, s_ctx) or not bool(
            ((out >= 0) & (out < cfg.vocab_size)).all()) or not torch.equal(
            out[:, :prompt_len].cpu(), prompt.to(torch.int32)):
        raise AssertionError(f"generate returned {tuple(out.shape)} "
                             f"{out.dtype}")
    calls = s_ctx - 1
    dense, experts = per_call_projections(cfg)
    check_counts(f"{cfg.name} generate ({cfg.policy})", counts, {
        "dpa_matmul_prequant": dense * cfg.n_layers * calls,
        "dpa_grouped_matmul_prequant": experts * cfg.n_layers * calls})
    print(f"  = {dense * cfg.n_layers} dense + {experts * cfg.n_layers} "
          f"grouped per model call x {calls} calls")
    new_tokens = out[:, prompt_len:].tolist()
    print(f"generate: {cfg.name} {n_prompts} prompts x {prompt_len} tokens "
          f"+ {n_new} new in {wall:.2f} s ({calls} model calls, "
          f"{wall / calls * 1e3:.1f} ms each); new tokens {new_tokens}")
    return counts, {"wall_s": wall, "model_calls": calls,
                    "ms_per_call": wall / calls * 1e3}


# -----------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler over one decode step and one
# prefill chunk of the full-width engine)
# -----------------------------------------------------------------------------

def profile_engine(model, params, ecfg):
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.engine import DECODE, Engine, synthetic_workload

    engine = Engine(model, params, ecfg, device="cuda")
    reqs = synthetic_workload(ecfg.max_batch, vocab=model.cfg.vocab_size,
                              seed=1, prompt_range=(64, 64),
                              gen_range=(32, 32))
    for r in reqs:
        engine.submit(r)
    while any(r.state != DECODE for r in reqs):
        engine.step()
    engine.step()
    chunk = torch.zeros((1, ecfg.prefill_chunk), dtype=torch.int64,
                        device="cuda")
    windows = {
        "decode step (B=4)": lambda: engine._decode_batch(0.0),
        "prefill chunk (32 tokens)": lambda: model.decode_step(
            params, {"tokens": chunk, "index": 0}, engine._staging),
    }
    out = {}
    for name, fn in windows.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_name = {}
        for e in kernels:
            dt = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + dt
        busy = sum(by_name.values())
        if not kernels:
            print(f"profile {model.cfg.name} {name}: wall {wall_ms:.1f} ms; "
                  "the profiler saw no device events (busy share not "
                  "measured)")
            out[name] = {"wall_ms": wall_ms, "busy_ms": None}
            continue
        print(f"profile {model.cfg.name} {name}: wall {wall_ms:.1f} ms, "
              f"device busy "
              f"{busy:.2f} ms ({busy / wall_ms:.1%}), {len(kernels)} "
              f"kernel launches")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        for kname, ms in top:
            print(f"    {ms:8.3f} ms  {kname[:100]}")
        out[name] = {"wall_ms": wall_ms, "busy_ms": busy,
                     "launches": len(kernels),
                     "top": [[k[:100], v] for k, v in top]}
    return out


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        fail(f"no port sources under {src}")
    sys.path.insert(0, str(src))

    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import build
    from repro_torch.launch.engine import EngineConfig

    t_start = time.monotonic()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    build.load_library()
    print(f"kernel build: {build.BUILD_INFO['seconds']:.1f} s "
          f"({'cached' if build.BUILD_INFO['cached'] else 'built'}) -> "
          f"{build.BUILD_INFO['path']}")
    for line in build.BUILD_INFO["log"].splitlines():
        if "registers" in line or line.startswith("=="):
            print("  " + line.strip())

    qwen = get_config("qwen3-4b").replace(policy="w4a8_kv4_attn8")
    granite = get_config("granite-moe-1b-a400m").replace(
        policy="w4a8_kv4_attn8")
    pol = get_policy(qwen.policy)
    ecfg = EngineConfig(page_size=16, n_pages=80, max_batch=4,
                        max_pages_per_req=16, token_budget=64,
                        prefill_chunk=32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)

    # phase 2: every kernel against its plain version
    mm_err, mm_t = check_matmul(qwen, gen, _dense_shapes(qwen))
    gmm_err, gmm_t = check_matmul(granite, gen, _dense_shapes(granite))
    pd_err, pd_t = check_paged(qwen, pol, gen, ecfg)
    gpd_err, gpd_t = check_paged(granite, pol, gen, ecfg)
    gf_err, gf_t = check_grouped_fused(granite, gen)
    pq_t = check_prequant(granite, gen)
    t_kernels = time.monotonic() - t_start

    # phase 3a / 4: qwen3-4b through the engine
    model, params, rep_q, n_q = run_engine(qwen, ecfg, agreement=True)
    prof_q = profile_engine(model, params, ecfg)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t_qwen = time.monotonic() - t_start

    # phase 3b / 4: granite-moe-1b through the engine (path A)
    model, params, rep_g, n_g = run_engine(granite, ecfg, agreement=False)
    prof_g = profile_engine(model, params, ecfg)
    # phase 3c: granite-moe-1b through generate under fp4_dpa_packed
    # (path B), on the same weights prepared for that policy
    n_b, gen_b = run_generate(granite.replace(policy="fp4_dpa_packed"),
                              params)
    del model, params
    t_total = time.monotonic() - t_start
    print(f"phase times: kernels {t_kernels:.1f} s, qwen3-4b "
          f"{t_qwen - t_kernels:.1f} s, granite-moe-1b "
          f"{t_total - t_qwen:.1f} s")

    def times(t):
        return {k: t[k] for k in TIME_KEYS + ("bound_ms",)}

    kernels = [
        {"name": "dpa_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:184",
         "launches": n_q["dpa_matmul_fused"] + n_g["dpa_matmul_fused"],
         "max_abs_err": max(mm_err, gmm_err), **times(mm_t),
         "bound_by": "bytes", "library_ms": None,
         "at": "qwen3-4b, one decoder layer's 7 projections at decode M=4",
         "granite": {"max_abs_err": gmm_err, **times(gmm_t),
                     "at": "granite-moe-1b, one layer's 4 attention "
                           "projections at decode M=4"}},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:332",
         "launches": (n_q["paged_decode_attention"]
                      + n_g["paged_decode_attention"]),
         "max_abs_err": max(pd_err, gpd_err), **times(pd_t),
         "bound_by": pd_t["bound_by"], "library_ms": None,
         "at": "one layer, B=4 H=32 KV=8 hd=128 page=16 lengths "
               "[256,201,101,18]",
         "hd64": {"max_abs_err": gpd_err, **times(gpd_t),
                  "at": "granite-moe-1b, H=16 KV=8 hd=64, same lengths"}},
        {"name": "dpa_matmul_prequant", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_prequant.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:95",
         "launches": n_b["dpa_matmul_prequant"],
         "max_abs_err": pq_t["dense"]["max_abs_err"], **times(pq_t["dense"]),
         "bound_by": "bytes", "library_ms": pq_t["dense"]["library_ms"],
         "library_device_ms": pq_t["dense"]["library_device_ms"],
         "at": "granite-moe-1b, one layer's 4 attention projections at "
               "M=8 (2 rows padded)"},
        {"name": "dpa_grouped_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_grouped_matmul.py:154",
         "launches": n_g["dpa_grouped_matmul_fused"],
         "max_abs_err": gf_err, **times(gf_t),
         "bound_by": "bytes", "library_ms": None,
         "at": "granite-moe-1b, one layer's 3 expert matmuls (E=32) at "
               "M=8 (4 rows padded)"},
        {"name": "dpa_grouped_matmul_prequant", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_prequant.cu",
         "replaces": "src/repro/kernels/dpa_grouped_matmul.py:75",
         "launches": n_b["dpa_grouped_matmul_prequant"],
         "max_abs_err": pq_t["grouped"]["max_abs_err"],
         **times(pq_t["grouped"]),
         "bound_by": "bytes", "library_ms": pq_t["grouped"]["library_ms"],
         "library_device_ms": pq_t["grouped"]["library_device_ms"],
         "at": "granite-moe-1b, one layer's 3 expert matmuls (E=32) at "
               "M=8 (2 rows padded)"},
    ]
    print("engine report: " + json.dumps(
        {"qwen3-4b": rep_q, "granite-moe-1b-a400m": rep_g}))
    print("generate: " + json.dumps(
        {"granite-moe-1b-a400m fp4_dpa_packed": gen_b}))
    print("profile: " + json.dumps(
        {"qwen3-4b": prof_q, "granite-moe-1b-a400m": prof_g}))
    print(f"total {t_total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
