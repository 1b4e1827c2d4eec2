"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (every failure raises; the exit code is then non-zero):

1. Card: name and power limit, torch and CUDA versions, and the build of
   the CUDA kernels from `src/repro_torch/csrc/` (timed).
2. Kernels against their plain PyTorch versions on the card, at the
   serving paths' shapes:
   - `dpa_matmul_fused` at every projection of qwen3-4b and at the
     attention projections of granite-moe-1b (M = 4 decode, padded to 8,
     and M = 32 prefill chunk; packed-fp4 weights timed, (fp8, fp8)
     checked), which the launch plan sends to its split-K route
     (`csrc/dpa_matmul.cu`); at each model's projection with the largest
     split also ragged M = 1, 17, 64, 127 for both weight formats, and
     the rows of M = 8 and 1 calls held to the same rows of an M = 64
     call with `torch.equal`; one decode layer also timed cold, rotating
     over the model's layers' weights; every (column tile, split) the
     route takes timed at the engines' shapes (the evidence for
     `splitk_cols`);
   - its tiled route (`fused_plan` from `TILED_MIN_M` rows on: the
     pre-pass `dpa_act_quant`, then fp16 tensor cores) at M = 4096 at
     each of qwen3-4b's five projection shapes with packed-fp4 weights,
     the (fp8, fp8) pair at K x N 2560 x 1024, the threshold M and a
     ragged M (threshold + 44), and grouped at E 32, M 256, K x N 1024 x
     512; the pre-pass's codes and scales held to its plain version
     exactly; one qwen3-4b layer at M = 4096 timed, with the pre-pass
     alone, the fp8 and fp16 operations bounds and, as speed references,
     bf16 `torch.matmul` and `torch._scaled_mm` with block scales (or its
     refusal); and both routes swept at M = 8 .. 512 on qwen3-4b's wg
     (and wk) — the split-K route at its plan also past the threshold —
     the evidence for the threshold;
   - `paged_decode_attention` at the engine's decode geometry plus the
     block-table edge cases (odd lengths, mid-page positions, an idle
     slot on the scratch page) and one long context (B 2, 2,048 pages of
     16, positions 32767 and 9000, timed), for qwen3-4b (hd 128, H 32, KV
     8) and granite-moe-1b (hd 64, H 16, KV 8); at the engine's shape
     every cluster split 1-8 is checked and timed beside the launch
     plan's (`paged_plan`);
   - `dpa_grouped_matmul_fused` at granite's expert shapes (E 32, K x N
     1024 x 512 and 512 x 1024) for M = 8 (decode, 4 rows padded) and
     M = 11 (a 32-token prefill chunk's capacity), both weight formats,
     with capacity-dropped zero rows, which must come out exactly 0; at
     the first shape ragged M and the row-invariance check as above; one
     decode layer timed cold over 24 layers' expert weights;
   - `dpa_matmul_prequant` at granite's attention projections and
     `dpa_grouped_matmul_prequant` at its expert shapes, held to
     `max_abs_err == 0` (fp4 x fp4 sums are exact) at M = 8 and 11 and at
     the launch plan's row-tile edges M = 1, 16, 17, 64, with every code
     at +-6, and at the largest |acc| the plan admits (K = 2^16 - 128);
     each shape's plan (column tile, split) is printed, one decode layer
     is also timed cold (rotating over 24 layers' weight codes, as path
     c walks them, for the kernel and the library call alike), and every
     (column tile, split) the kernel takes is timed at path c's shapes;
   - `flash_attention` at one layer of qwen3-4b's prefill (S 4096, H 32,
     KV 8, hd 128) on f32 and bf16 inputs, at hd 64 and at S 1000 (key
     blocks of 125), against the global-softmax plain version; both
     dtypes timed at S 4096 (both on split-bf16 tensor cores: bf16, path
     C's instance, bound at three bf16 products; f32, after its K/V
     pre-pass, at six), with `scaled_dot_product_attention` in f32 as the
     library yardstick and in bf16 as a speed reference;
   - `dpa_flash_attention` at the same layer (raw K/V on the fp4 grid,
     bf16: the wrapper's pre-pass quantizes K and V once with the row
     quantizers, then the kernel runs on the packed codes), with fp8 K/V,
     and in cache mode (packed and unpacked fp4, fp8 codes), counting the
     probability codes that differ; timed with the pre-pass and without,
     beside bf16 `scaled_dot_product_attention` as a speed reference;
   - `quantize_rows` and `quantize_pack_rows`, every instance (E4M3,
     E5M2, E2M1, packed E2M1, fp16, bf16, f32) on f32 and bf16 x, at M
     4096 x K 2560 and 9728, path D's pre-pass rows (32,768 x 128), hd 64
     rows, K 334 and 335 (the scalar route), rows past what a block holds
     (the reread routes) and an offset view, held to identical codes and
     scales, each case's launch plan printed; timed at 4096 x 9728 and
     32,768 x 128.
   Each kernel, its plain version and (for the prequant pair)
   `torch._scaled_mm` / `torch._scaled_grouped_mm` on the e4m3-widened
   codes are timed two ways: `ms` / `plain_ms` / `library_ms`, the median
   of 25 CUDA-event-bracketed calls (which includes the host's launch
   time), and `device_ms` / `plain_device_ms` / `library_device_ms`, the
   profiler's device time per call over 20 calls (or, where the profiler
   records no device activity, CUDA events around a CUDA-graph replay of
   20 calls; `device_from` says which); beside them the least
   time the card could take (bytes over 3.35 TB/s, or operations over the
   fp8 peak — for the f32 flash kernel three (bf16 inputs) or six (f32
   inputs) bf16 products at the bf16 peak — whichever is larger).
3. Serving at full width, seeded random weights, policy w4a8_kv4_attn8
   unless said otherwise; the kernel launch counters
   (`repro_torch.kernels.counters`) are zeroed just before each path and
   read just after.  The serving paths run eagerly (`graphs=False`, the
   reference) and with their steps as CUDA graphs
   (`launch.graphs.StepGraph`; a replay adds its capture's counts), the
   engines four times in turns (`SERVE_ORDER`), `generate` once each
   way, and every request's tokens must be equal in every run; after the
   first graphed run one profiler window over a single replay of each
   graph must show each
   watched kernel (`dpa_fused_kernel`, `paged_decode`,
   `dpa_prequant_kernel`) as often as the capture counted; capture time
   and the graphs' pool bytes are printed:
   a. qwen3-4b (36 layers) serves 8 synthetic requests through the
      continuous-batching engine: every projection through the fused
      kernel's split-K route, every decode step's attention through the
      paged kernel; two requests are replayed through `generate` and
      teacher-forced through the static path (greedy agreement and the
      top-2 margins where the paths differ, reported);
   b. granite-moe-1b-a400m (24 layers, 32 experts top-8) serves 8
      synthetic requests through the engine: attention projections
      through the fused kernel, expert matmuls through the grouped fused
      kernel (both on the split-K route), decode attention through the
      paged kernel (hd 64), the same replay against `generate`; and
      its first layer's `apply_moe` runs three times on one bf16 input,
      which must give the same bits each time;
   c. granite-moe-1b under fp4_dpa_packed through `generate` (2 prompts
      of 32 tokens, 16 new): attention projections through the dense
      prequant kernel, experts through the grouped prequant kernel,
      attention in f32 over a raw bf16 cache (the graphed run's step 0
      is its capture's one warm-up call);
   d. qwen3-4b's prefill of one 4096-token prompt (`make_prefill_step`)
      under its own policy fp8_dpa with use_flash, on the engine's
      weights: every layer's attention through the f32 flash kernel's
      bf16 instance;
   e. qwen3-4b's full-sequence scoring (the forward of `make_loss_fn`,
      chunked cross-entropy) of one 4096-token sequence under
      w4a8_kv4_attn8 with use_flash: every layer's attention through the
      DPA flash kernel after its pre-pass (two `quantize_pack_rows`
      launches a layer, K and V), every projection through the fused
      matmul's tiled route (M = 4096: as many tiled and pre-pass
      launches as fused ones; every other path makes no tiled launch);
   f. the `quantize_pack` op (`kernels.ops.quantize_rows`) on a prompt's
      MLP activations: both row quantizers (packed E2M1; E4M3, E5M2 and
      f32 codes).
   The expected counts are computed from the config and the run; d and e
   are each compared with the same call with use_flash off, and every
   layer's attention output on them with the kernel's plain version on
   the same inputs (on e with both sides' probability codes, to phase
   2's flip-aware bound).
4. Where the time goes: torch.profiler over one steady decode step and
   one prefill chunk of each engine and one serve step of path c, each
   eager and graphed (wall, device busy share, launches; the prequant
   kernels' share on path c), and over one call of paths d and e
   (device busy share, top kernels); summary lines per step and mode.

Prints the engine reports, the prefill and scoring results and the
profiles as JSON, the phase times, the kernels' JSON line, the card's
name and power limit, and, as the last line,
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or without the
repository's sources.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM HBM3 (data sheet)
FP8_OPS_PER_S = 1979e12           # H100 SXM dense fp8 tensor-core peak
FP16_OPS_PER_S = 989e12           # H100 SXM dense fp16 tensor-core peak
F32_OPS_PER_S = 67e12             # H100 SXM f32 outside the tensor cores
MATMUL_RTOL, MATMUL_ATOL = 2e-5, 2e-4   # the reference's fused-route pin
FLASH_F32_RTOL = 2e-6             # the f32 flash route's pin (no TF32)
# DPA flash kernel vs plain version: at most this share of the live
# probability codes may differ (a logit summed in another order can cross
# an E4M3 rounding boundary); each output is held to one bf16 ulp plus
# FLASH_F32_RTOL of its row's largest output, plus, in a row with flipped
# codes, what those flips can move it by
DPA_FLASH_MAX_FLIPS = 1e-5
# path D against use_flash off (global-max p quantization): 10x the gap
# measured on an H100 (1.1e-3, PERF.md)
SCORING_REF_TOL = 1e-2


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


def device_ms_from(fn, n: int = 20):
    """Device time of fn per call, and where it came from: the durations
    of the device activities (kernels, copies, fills) of n calls under
    torch.profiler, summed and divided by n, after warm-up ("profiler").
    Unlike `median_ms`, which brackets one call with CUDA events, it
    counts no device idle time while the host prepares a launch — at
    these sizes that host time is most of a call.

    Short profiler sessions sometimes return no device records, for a
    stretch of several sessions.  Where two sessions half a second apart
    both return none, the time comes from CUDA events around one replay
    of n calls captured in a CUDA graph ("graph replay"), which has no
    host gaps between the launches; (None, None) where capture fails."""
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
            return sum(spans) / 1e3 / n, "profiler"
    ms = graph_ms(fn, n)
    return ms, None if ms is None else "graph replay"


def device_ms(fn, n: int = 20):
    """`device_ms_from`'s time alone."""
    return device_ms_from(fn, n)[0]


def graph_ms(fn, n: int = 20):
    """CUDA-event time per call of one replay of n calls of fn captured
    in a CUDA graph, after a warm-up replay; None where fn cannot be
    captured (it synchronizes or touches the host)."""
    import torch
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n
    except RuntimeError as e:      # not capturable: not measured
        print(f"  graph capture refused ({str(e)[:100]})")
        return None


def bound(nbytes: float, ops: float, peak: float = FP8_OPS_PER_S):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


TIME_KEYS = ("ms", "plain_ms", "device_ms", "plain_device_ms")


def timings(kernel, plain) -> dict:
    """A kernel's and its plain version's time per call, each both ways:
    `ms` / `plain_ms` the median CUDA-event time of one call (host launch
    time included), `device_ms` / `plain_device_ms` the device time per
    call (`device_ms_from`; `device_from` says where the kernel's came
    from)."""
    dev, src = device_ms_from(kernel)
    return {"ms": median_ms(kernel), "plain_ms": median_ms(plain),
            "device_ms": dev, "plain_device_ms": device_ms(plain),
            "device_from": src}


def fmt_times(t: dict) -> str:
    def dev(v, digits):
        return "not measured" if v is None else f"{v:.{digits}f}"
    return (f"kernel_ms {t['ms']:.4f} (device {dev(t['device_ms'], 4)}) "
            f"plain_ms {t['plain_ms']:.3f} (device "
            f"{dev(t['plain_device_ms'], 3)})")


# -----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# -----------------------------------------------------------------------------

FP4_FUSED = dict(fmt_x="fp8_e4m3", fmt_w="fp4_e2m1", pack_w=True)
FP8_FUSED = dict(fmt_x="fp8_e4m3", fmt_w="fp8_e4m3", pack_w=False)
# rows at which the split-K route is also checked (untimed): one row, a
# ragged tile, the token budget, the last row count below TILED_MIN_M
RAGGED_M = (1, 17, 64, 127)


def _plan_str(plan) -> str:
    return (f"plan {plan.route} bm {plan.bm} bn {plan.bn} split "
            f"{plan.split} ({plan.blocks} blocks)")


def _held(what, got, want):
    """got within the fused route's pin of want and finite, or raise; ->
    max |got - want|."""
    import torch
    err, ok = _close(got, want)
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max err {err} over rtol {MATMUL_RTOL}"
                             f" / atol {MATMUL_ATOL}")
    return err


def rows_invariant(what, kern, x, args, kw, sub=(8, 1)):
    """The first `sub` rows of x alone give the same bits as the same rows
    of the whole call (x has 64 rows; the rows sit on dim -2)."""
    import torch
    full = kern(x, *args, **kw)
    for m in sub:
        part = kern(x[..., :m, :].contiguous(), *args, **kw)
        if not torch.equal(part, full[..., :m, :]):
            raise AssertionError(
                f"{what}: rows of an M={m} call differ from the same rows of "
                f"an M={x.shape[-2]} call (max "
                f"{float((part - full[..., :m, :]).abs().max())})")
    print(f"{what}: the rows of M={', '.join(map(str, sub))} calls equal the "
          f"same rows of an M={x.shape[-2]} call (torch.equal)")


def check_matmul(cfg, gen, projections, cold_layers):
    """Every (K, N) of `projections` (name -> (K, N), the dense
    projections one layer of the model runs through this kernel) at M = 4
    (the engine's decode step, padded to 8 as the pipeline pads it) and
    32 (a prefill chunk), bf16 x, packed-fp4 weights prepared as the model
    prepares them, timed; the (fp8, fp8) pair at both, untimed.  At the
    projection with the largest split: ragged M (`RAGGED_M`) for both
    pairs, and the rows of M = 8 and 1 against those of M = 64.  One
    decode layer is also timed cold, rotating over `cold_layers` layers'
    weights."""
    import torch
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import (dpa_matmul_fused_pipeline,
                                         prep_weights)
    shapes = sorted(set(projections.values()))
    edge = max(shapes, key=lambda kn: (DM.fused_plan(1, 8, *kn).split, kn))
    worst = 0.0
    timed, plans = {}, {}
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_weights(w.to(torch.bfloat16), cfg.policy)
        prep8 = prep_weights(w.to(torch.bfloat16), "fp8_dpa_fused")
        for M in (4, 32):
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            # the kernel's own inputs: the pipeline's padding of M
            xp = torch.nn.functional.pad(x, (0, 0, 0, max(8, M) - M))
            args = (xp, prep["wq"], prep["sw"])
            kw = FP4_FUSED
            plan = DM.fused_plan(1, xp.shape[0], K, N)
            plans[f"{K}x{N} M={xp.shape[0]}"] = plan._asdict()
            got = DM.dpa_matmul_fused(*args, **kw)
            want = DM.dpa_matmul_fused_ref(*args, **kw)
            torch.cuda.synchronize()
            err = _held(f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M}",
                        got, want)
            worst = max(worst, err)
            # and through the pipeline the model calls (pads, slices, casts)
            pipe = dpa_matmul_fused_pipeline(x, prep, cfg.policy)
            if pipe.shape != (M, N) or pipe.dtype != torch.bfloat16:
                raise AssertionError(f"pipeline gave {pipe.dtype} "
                                     f"{tuple(pipe.shape)}")
            t = timings(lambda: DM.dpa_matmul_fused(*args, **kw),
                        lambda: DM.dpa_matmul_fused_ref(*args, **kw))
            nbytes = (xp.numel() * 2 + prep["wq"].numel()
                      + prep["sw"].numel() * 4 + xp.shape[0] * N * 4)
            t["bound_ms"], b_by = bound(nbytes, 2.0 * xp.shape[0] * K * N)
            timed[(K, N, M)] = t
            # the kernel's other fmt pair, (fp8, fp8) weights: untimed
            err8 = _held(f"dpa_matmul_fused {cfg.name} fp8 weights K={K} "
                         f"N={N} M={M}",
                         DM.dpa_matmul_fused(xp, prep8["wq"], prep8["sw"],
                                             **FP8_FUSED),
                         DM.dpa_matmul_fused_ref(xp, prep8["wq"],
                                                 prep8["sw"], **FP8_FUSED))
            worst = max(worst, err8)
            print(f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M}: "
                  f"{_plan_str(plan)}; max_abs_err {err:.3g} (fp8 weights "
                  f"{err8:.3g}) {fmt_times(t)} bound_ms {t['bound_ms']:.5f} "
                  f"({b_by})")
        if (K, N) != edge:
            continue
        for M in RAGGED_M:
            x = torch.randn((M, K), generator=gen, device="cuda").to(
                torch.bfloat16)
            for kw, p_ in ((FP4_FUSED, prep), (FP8_FUSED, prep8)):
                args = (x, p_["wq"], p_["sw"])
                err = _held(f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M} "
                            f"{kw['fmt_w']}", DM.dpa_matmul_fused(*args, **kw),
                            DM.dpa_matmul_fused_ref(*args, **kw))
                worst = max(worst, err)
                print(f"dpa_matmul_fused {cfg.name} K={K} N={N} M={M} "
                      f"{kw['fmt_w']} weights: "
                      f"{_plan_str(DM.fused_plan(1, M, K, N))}; max_abs_err "
                      f"{err:.3g}")
        x = torch.randn((64, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        rows_invariant(f"dpa_matmul_fused {cfg.name} K={K} N={N}",
                       DM.dpa_matmul_fused, x, (prep["wq"], prep["sw"]),
                       FP4_FUSED)
    per_layer = _per_layer(timed, projections, 4)
    per_layer["plans"] = plans
    per_layer["cold"] = cold_fused_layer(DM.dpa_matmul_fused, projections, (),
                                         8, cold_layers, gen)
    print(f"dpa_matmul_fused {cfg.name}: {len(projections)} launches per "
          f"layer per model call, {len(projections) * cfg.n_layers} per "
          f"decode step; one decode layer (M=4, padded to 8), warm: "
          f"{fmt_times(per_layer)}, cold {per_layer['cold']['device_ms']} "
          f"(device), bound {per_layer['bound_ms']:.5f} ms")
    return worst, per_layer


def cold_fused_layer(kern, shapes, lead, M, layers, gen):
    """One decode layer of a fused wrapper rotating over `layers` layers'
    distinct weights (random packed E2M1 codes and positive column
    scales: the kernel's work does not depend on their values), as the
    engine walks them (`cold_layer`; no library call computes this
    function)."""
    import torch
    xs = {name: torch.randn(lead + (M, K), generator=gen, device="cuda").to(
        torch.bfloat16) for name, (K, N) in shapes.items()}
    calls = []
    for _ in range(layers):
        for name, (K, N) in shapes.items():
            wq = torch.randint(0, 256, lead + (K // 2, N), generator=gen,
                               device="cuda", dtype=torch.int32).to(
                                   torch.uint8)
            sw = torch.rand(lead + (1, N), generator=gen, device="cuda") + 0.05
            calls.append(lambda a=(xs[name], wq, sw): kern(*a, **FP4_FUSED))
    return cold_layer(kern.__name__, M, layers, calls)


FP16_OPS_PER_S = 989e12           # H100 SXM dense fp16 tensor-core peak
LARGE_M = 4096                    # path D's rows: one 4096-token sequence


def _close(got, want):
    """-> (max |got - want|, within the fused route's pin)."""
    err = (got - want).abs()
    return float(err.max()), bool(
        (err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all())


def _scaled_mm_blockwise(codes, scales, wq, N):
    """`torch._scaled_mm` on the same E4M3 activation codes with their
    1 x 128 block scales and the weights widened to e4m3 (128 x 128 block
    scales of 1, so not the same function: a speed reference only), as a
    function of no arguments, or (None, why)."""
    import torch
    from repro_torch.kernels.dpa_matmul import widen
    if not hasattr(torch, "_scaled_mm"):
        return None, f"torch {torch.__version__} has no _scaled_mm"
    x8 = codes.view(torch.float8_e4m3fn)
    w8 = widen(wq, "fp4_e2m1", packed=True).t().contiguous().t().to(
        torch.float8_e4m3fn)
    K = x8.shape[1]
    sb = torch.ones((K // 128, N // 128), device=codes.device)
    why = "refused"
    for sa_, sb_ in ((scales, sb), (scales.t().contiguous().t(),
                                    sb.t().contiguous().t())):
        call = (lambda a=sa_, b=sb_: torch._scaled_mm(  # noqa: E731
            x8, w8, scale_a=a, scale_b=b, out_dtype=torch.bfloat16))
        try:
            call()
            return call, "torch._scaled_mm, 1x128 x 128x128 block scales"
        except (RuntimeError, TypeError, ValueError) as e:   # a yardstick
            why = f"refused: {str(e)[:160]}"
    return None, why


def check_fused_tiled(cfg, gen, projections):
    """The fused kernel's tiled route (`fused_plan` from TILED_MIN_M rows
    on) against the plain version at the fused route's pin: M = 4096 at
    every (K, N) of `projections` (one qwen3-4b layer) with packed-fp4
    weights (a row with an all-zero K block, a row scaled by 1e3), the
    (fp8, fp8) pair at the first, the threshold M and a ragged M, and the
    grouped kernel at E = 32, M = 256 (or the threshold), K x N = 1024 x
    512.  One layer at M = 4096 is timed: the route (pre-pass included),
    the pre-pass alone, the plain version, the fp8 and fp16 operations
    bounds and, as speed references for the same (M, K, N), bf16
    `torch.matmul` and `torch._scaled_mm` with block scales."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_grouped_weights, prep_weights
    kw = FP4_FUSED
    worst, timed = 0.0, {}

    def check(fn, ref, args, label, E=1, **kw_):
        M, K = args[0].shape[-2:]
        plan = DM.fused_plan(E, M, K, args[1].shape[-1])
        if plan.route != "tiled":
            raise AssertionError(f"{label}: plan {plan}, not the tiled route")
        got = fn(*args, **kw_)
        err, ok = _close(got, ref(*args, **kw_))
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{fn.__name__} tiled {label}: max err {err}"
                                 f" over rtol {MATMUL_RTOL} / atol "
                                 f"{MATMUL_ATOL}")
        print(f"{fn.__name__} tiled {label}: max_abs_err {err:.3g} (plan "
              f"{plan.bm}x{plan.bn}, {plan.blocks} blocks)")
        return err

    for K, N in sorted(set(projections.values())):
        w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_weights(w.to(torch.bfloat16), cfg.policy)
        x = torch.randn((LARGE_M, K), generator=gen, device="cuda")
        x[7, 128:256] = 0
        x[9] *= 1e3
        x = x.to(torch.bfloat16)
        args = (x, prep["wq"], prep["sw"])
        worst = max(worst, check(DM.dpa_matmul_fused, DM.dpa_matmul_fused_ref,
                                 args, f"{cfg.name} K={K} N={N} "
                                 f"M={LARGE_M}", **kw))
        codes, scales = DM.dpa_act_quant(x)
        want_c, want_s = DM.dpa_act_quant_ref(x)
        if not (torch.equal(codes, want_c) and torch.equal(scales, want_s)):
            raise AssertionError(f"dpa_act_quant K={K}: codes or scales "
                                 "differ from the plain version")
        t = timings(lambda: DM.dpa_matmul_fused(*args, **kw),
                    lambda: DM.dpa_matmul_fused_ref(*args, **kw))
        pre = timings(lambda: DM.dpa_act_quant(x),
                      lambda: DM.dpa_act_quant_ref(x))
        ops = 2.0 * LARGE_M * K * N
        nbytes = (x.numel() * 2 + prep["wq"].numel() + prep["sw"].numel() * 4
                  + LARGE_M * N * 4)
        t["bound_ms"], _ = bound(nbytes, ops)
        t["fp16_bound_ms"], _ = bound(nbytes, ops, FP16_OPS_PER_S)
        t["prepass_ms"], t["prepass_device_ms"] = pre["ms"], pre["device_ms"]
        pre["bound_ms"], _ = bound(x.numel() * 2 + codes.numel()
                                   + scales.numel() * 4, 0.0)
        timed[("pre", K)] = pre
        wb = w.to(torch.bfloat16)
        t["bf16_matmul_ms"] = median_ms(lambda: torch.matmul(x, wb))
        t["bf16_matmul_device_ms"] = device_ms(lambda: torch.matmul(x, wb))
        call, note = _scaled_mm_blockwise(codes, scales, prep["wq"], N)
        t["scaled_mm_ms"] = None if call is None else median_ms(call)
        t["scaled_mm_device_ms"] = None if call is None else device_ms(call)
        t["scaled_mm"] = note
        timed[(K, N, LARGE_M)] = t
        print(f"dpa_matmul_fused tiled K={K} N={N} M={LARGE_M}: "
              f"{fmt_times(t)} bound_ms {t['bound_ms']:.4f} (fp8 ops; fp16 "
              f"{t['fp16_bound_ms']:.4f}); pre-pass {pre['ms']:.4f} ms "
              f"(device {pre['device_ms']}), bound {pre['bound_ms']:.4f}; "
              f"speed references (not the same function): bf16 "
              f"torch.matmul {t['bf16_matmul_ms']:.4f} ms (device "
              f"{t['bf16_matmul_device_ms']}), {note} {t['scaled_mm_ms']} "
              f"ms (device {t['scaled_mm_device_ms']})")
        if (K, N) == sorted(set(projections.values()))[0]:
            prep8 = prep_weights(w.to(torch.bfloat16), "fp8_dpa_fused")
            worst = max(worst, check(
                DM.dpa_matmul_fused, DM.dpa_matmul_fused_ref,
                (x, prep8["wq"], prep8["sw"]),
                f"{cfg.name} K={K} N={N} M={LARGE_M} fp8 weights",
                **FP8_FUSED))
            for M in (DM.TILED_MIN_M, DM.TILED_MIN_M + 44):
                xm = x[:M].contiguous()
                worst = max(worst, check(
                    DM.dpa_matmul_fused, DM.dpa_matmul_fused_ref,
                    (xm, prep["wq"], prep["sw"]),
                    f"{cfg.name} K={K} N={N} M={M}", **kw))
    # grouped: granite's expert shape at a large capacity
    E, M, K, N = 32, max(256, DM.TILED_MIN_M), 1024, 512
    w3 = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
    prep = prep_grouped_weights(w3, "w4a8_kv4_attn8")
    x = torch.randn((E, M, K), generator=gen, device="cuda")
    x = _drop(x, [M] * (E - 2) + [M // 3, 0]).to(torch.bfloat16)
    worst = max(worst, check(
        GM.dpa_grouped_matmul_fused, GM.dpa_grouped_matmul_fused_ref,
        (x, prep["wq"], prep["sw"]), f"E={E} K={K} N={N} M={M}", E=E,
        **kw))
    layer = _per_layer(timed, projections, LARGE_M)
    for key in ("fp16_bound_ms", "bf16_matmul_ms", "bf16_matmul_device_ms",
                "scaled_mm_ms", "scaled_mm_device_ms", "prepass_ms",
                "prepass_device_ms"):
        vals = [timed[(K, N, LARGE_M)][key] for K, N in projections.values()]
        layer[key] = None if None in vals else sum(vals)
    pre = {key: [timed[("pre", K)][key] for K, _ in projections.values()]
           for key in TIME_KEYS + ("bound_ms",)}
    layer["prepass"] = {k: None if None in v else sum(v)
                        for k, v in pre.items()}
    layer["prepass"]["max_abs_err"] = 0.0
    layer["scaled_mm"] = note
    layer["max_abs_err"] = worst
    print(f"dpa_matmul_fused tiled, one {cfg.name} layer at M={LARGE_M} "
          f"({len(projections)} calls): {fmt_times(layer)}, bound "
          f"{layer['bound_ms']:.4f} ms (fp8 ops; fp16 "
          f"{layer['fp16_bound_ms']:.4f}); pre-pass {layer['prepass_ms']} "
          f"ms (device {layer['prepass_device_ms']}); bf16 torch.matmul "
          f"{layer['bf16_matmul_ms']} ms (device "
          f"{layer['bf16_matmul_device_ms']}); _scaled_mm "
          f"{layer['scaled_mm_ms']} ms (device {layer['scaled_mm_device_ms']})")
    return worst, layer


SWEEP_M = (8, 16, 32, 64, 128, 256, 512)
SWEEP_SHAPES = ((2560, 9728), (2560, 1024))   # qwen3-4b wg (the sweep), wk


def _splitk_launch(lib, x, wq, w_fmt, sw, out, E, M, K, N, bm, bn, split):
    """One launch of csrc/dpa_matmul.cu through its C entry point (bf16
    x): no wrapper, so no path's launch count."""
    import torch
    from repro_torch.kernels import build as B
    B.check(lib.dpa_grouped_fused_launch(
        x.data_ptr(), 1, wq.data_ptr(), w_fmt, sw.data_ptr(), out.data_ptr(),
        E, M, K, N, bm, bn, split, torch.cuda.current_stream().cuda_stream),
        "dpa_grouped_fused_launch")


def sweep_fused_plan(gen):
    """Both routes of the fused kernel at qwen3-4b's wg (K 2560, N 9728)
    and its narrowest projection wk (N 1024), M = 8 .. 512, through the C
    entry points (no path's launches): the split-K route at its plan's
    (bn, split) and rows, also past the threshold, and the tiled route
    with its pre-pass; each held to the plain version and timed on the
    device: the evidence for `TILED_MIN_M`."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_weights
    lib = B.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for (K, N), M in ((kn, M) for kn in SWEEP_SHAPES for M in SWEEP_M):
        prep = prep_weights((torch.randn((K, N), generator=gen, device="cuda")
                             * K ** -0.5).to(torch.bfloat16), "w4a8_kv4_attn8")
        x = torch.randn((M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        want = DM.dpa_matmul_fused_ref(x, prep["wq"], prep["sw"], **FP4_FUSED)
        out = torch.empty_like(want)
        codes = torch.empty((M, K), dtype=torch.uint8, device="cuda")
        scales = torch.empty((M, K // 128), device="cuda")
        bn, split = DM.splitk_cols(1, K, N)
        bm = DM.splitk_rows(M, K, bn, split)

        def splitk():
            _splitk_launch(lib, x, prep["wq"], 0, prep["sw"], out, 1, M, K, N,
                           bm, bn, split)

        def tiled():
            B.check(lib.dpa_act_quant_launch(
                x.data_ptr(), 1, codes.data_ptr(), scales.data_ptr(), M, K,
                stream), "dpa_act_quant_launch")
            B.check(lib.dpa_fused_tiled_launch(
                codes.data_ptr(), scales.data_ptr(), prep["wq"].data_ptr(),
                0, prep["sw"].data_ptr(), out.data_ptr(), 1, M, K, N,
                stream), "dpa_fused_tiled_launch")

        row = {}
        for name, fn in (("splitk", splitk), ("tiled", tiled)):
            out.fill_(float("nan"))
            fn()
            err, ok = _close(out, want)
            if not ok:
                raise AssertionError(f"fused {name} M={M}: max err {err}")
            row[name], row[name + "_from"] = device_ms_from(fn)
        route = DM.fused_plan(1, M, K, N).route
        res[f"{K}x{N} M={M}"] = {**row, "splitk_plan": f"bm{bm}/bn{bn}/s"
                                 f"{split}", "plan": route}
        print(f"fused plan sweep K={K} N={N} M={M}: splitk (bm {bm} bn {bn} "
              f"split {split}) {row['splitk']} ms, tiled {row['tiled']} ms "
              f"(device, per call); the plan takes {route}")
    return res


def sweep_splitk_plans(gen, M=8):
    """Every (bn, split) the split-K route takes at the engines' shapes
    (qwen3-4b's five projections, granite-moe-1b's two attention shapes
    and its two expert shapes at E 32) at the decode step's M = 8,
    through the C entry point (no path's launches), each held to the
    plain version at the pin and timed on the device: the evidence for
    `splitk_cols`."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_grouped_weights
    lib = B.load_library()
    res = {}
    shapes = [(1, K, N) for K, N in ((2560, 4096), (2560, 1024), (4096, 2560),
                                     (2560, 9728), (9728, 2560), (1024, 1024),
                                     (1024, 512))]
    shapes += [(32, 1024, 512), (32, 512, 1024)]
    for E, K, N in shapes:
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_grouped_weights(w, "w4a8_kv4_attn8")
        x = torch.randn((E, M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        want = GM.dpa_grouped_matmul_fused_ref(x, prep["wq"], prep["sw"],
                                               **FP4_FUSED)
        out = torch.empty_like(want)
        times = {}
        for bn in DM.SPLITK_COLS:
            for split in range(1, DM.MAX_CLUSTER + 1):
                if N % bn or (K // DM.BK) % split or DM.splitk_smem_bytes(
                        8, bn, K, split) > DM.SMEM_LIMIT:
                    continue

                def call(bn=bn, split=split):
                    _splitk_launch(lib, x, prep["wq"], 0, prep["sw"], out, E,
                                   M, K, N, 8, bn, split)
                out.fill_(float("nan"))
                call()
                err, ok = _close(out, want)
                if not ok:
                    raise AssertionError(f"splitk E={E} K={K} N={N} bn {bn} "
                                         f"split {split}: max err {err}")
                times[f"bn{bn}/s{split}"] = device_ms(call)
        bn, split = DM.splitk_cols(E, K, N)
        best = min((v, k) for k, v in times.items() if v is not None)[1] \
            if any(v is not None for v in times.values()) else None
        res[f"E{E} {K}x{N}"] = {"plan": f"bn{bn}/s{split}", "best": best,
                                "device_us": {k: None if v is None else
                                              v * 1e3
                                              for k, v in times.items()}}
        print(f"splitk plans E={E} K={K} N={N} M={M} (device us; the plan "
              f"takes bn{bn}/s{split}, the fastest {best}): " + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v * 1e3:.2f}'}"
                  for k, v in times.items()))
    return res


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


def _paged_bytes(cfg, lengths, q, table):
    """Bytes one paged decode call must move: each live K and V row's
    packed codes and scale once, q read and the output written, the block
    table and positions."""
    live_rows = sum(lengths) * cfg.n_kv_heads
    return (2 * live_rows * (cfg.hd // 2 + 4)
            + 2 * q.numel() * q.element_size() + table.numel() * 4
            + len(lengths) * 4)


def check_paged(cfg, pol, gen, ecfg):
    """The kernel against the gather + dpa_attention plain version.

    The two sum in different orders, so logits differ in the last f32
    bits, exp then differs by ulps, and a probability code can flip to its
    E4M3 neighbour where p / psq sits at a rounding midpoint.  The pin
    (`PAGED_DECODE_CARD_TOL`, 2e-2 absolute) admits such a flip where its
    weight is small against the denominator, and catches a wrong row,
    page, rank or mask, which moves outputs by O(1).  Cases: the engine's
    decode geometry (timed), block-table edges, and one long context (B 2,
    positions 32767 and 9000, 2,048 pages of 16; timed), each at the
    launch plan's split; at the engine's shape every split 1-8 is also
    checked and timed (`paged_plan`'s evidence)."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.registry import PAGED_DECODE_CARD_TOL as TOL
    kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, kv_packed=pol.kv_packed)

    def plan_of(q, cache):
        return PD.paged_plan(q.shape[0], cfg.n_kv_heads,
                             cfg.n_heads // cfg.n_kv_heads, cfg.hd,
                             cache["k_codes"].shape[3],
                             cache["k_codes"].shape[1],
                             cache["block_table"].shape[1])

    def held(name, got, want):
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or float(err.max()) > TOL:
            raise AssertionError(f"paged_decode_attention {name}: max err "
                                 f"{float(err.max())} > {TOL}")
        return err

    def compare(name, q, cache, pos):
        args = (q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
                cache["v_scale"], cache["block_table"], pos)
        got = PD.paged_decode_attention(*args, **kw)
        want = PD.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        err = held(name, got, want)
        plan = plan_of(q, cache)
        print(f"paged_decode_attention hd={cfg.hd} {name} (split "
              f"{plan.split}, {plan.blocks} blocks): max_abs_err "
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
    main_plan = plan_of(q, cache)
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

    def bound_of(lengths, args):
        ops = 2 * 2 * sum(lengths) * cfg.n_heads * cfg.hd
        return bound(_paged_bytes(cfg, lengths, args[0], args[5]), ops)

    t = timings(lambda: PD.paged_decode_attention(*main_args, **kw),
                lambda: PD.paged_decode_attention_ref(*main_args, **kw))
    t["bound_ms"], t["bound_by"] = bound_of(lengths, main_args)
    t["split"] = main_plan.split
    print(f"paged_decode_attention hd={cfg.hd} B=4: {fmt_times(t)} bound_ms "
          f"{t['bound_ms']:.6f} ({t['bound_by']}); 1 launch per layer, "
          f"{cfg.n_layers} per decode step")

    # every split at the engine's shape, each held to the plain version
    lib = B.load_library()
    qm, kc, ks, vc, vs, table, posm = main_args
    want = PD.paged_decode_attention_ref(*main_args, **kw)
    out = torch.empty_like(qm)
    splits = {}
    for split in range(1, PD.MAX_CLUSTER + 1):
        def call(split=split):
            B.check(lib.paged_decode_launch(
                qm.data_ptr(), 1, kc.data_ptr(), ks.data_ptr(), vc.data_ptr(),
                vs.data_ptr(), table.data_ptr(), posm.data_ptr(),
                out.data_ptr(), qm.shape[0], cfg.n_heads, cfg.n_kv_heads,
                cfg.hd, kc.shape[1], table.shape[1], 0, cfg.hd ** -0.5,
                split, torch.cuda.current_stream().cuda_stream),
                f"paged_decode split {split}")
        call()
        torch.cuda.synchronize()
        err = held(f"split {split}", out, want)
        splits[split] = device_ms(call)
        print(f"  split {split}: max_abs_err {float(err.max()):.3g}, device "
              f"{splits[split]} ms")
    timed = {k: v for k, v in splits.items() if v is not None}
    best = min(timed, key=timed.get) if timed else None
    print(f"paged_decode_attention hd={cfg.hd} splits at the engine shape "
          f"(device ms; the plan takes {main_plan.split}, the fastest "
          f"{best}): " + ", ".join(f"{k} {v}" for k, v in splits.items()))
    t["splits_device_ms"] = splits

    # one long context, beyond the parent kernel's shared-memory cap
    long_lengths = [32768, 9001]
    q, cache, pos = _paged_case(cfg, pol, gen, long_lengths, 16,
                                [32767, 9000])
    e, long_args = compare("B=2 page=16 2048 pages positions [32767,9000]",
                           q, cache, pos)
    worst = max(worst, e)
    lt = timings(lambda: PD.paged_decode_attention(*long_args, **kw),
                 lambda: PD.paged_decode_attention_ref(*long_args, **kw))
    lt["bound_ms"], lt["bound_by"] = bound_of(long_lengths, long_args)
    lt["split"] = plan_of(q, cache).split
    print(f"paged_decode_attention hd={cfg.hd} long context: "
          f"{fmt_times(lt)} bound_ms {lt['bound_ms']:.6f} "
          f"({lt['bound_by']})")
    t["long"] = {k: lt[k] for k in TIME_KEYS + ("bound_ms", "split")}
    del q, cache, pos, long_args
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
    pads them), M = 11 a 32-token prefill chunk's capacity, both timed;
    the (fp8, fp8) pair at both, untimed; at the first shape also ragged M
    (`RAGGED_M`, both pairs) and the rows of M = 8 and 1 against those of
    M = 64.  Zero rows must give exactly 0.  One decode layer is also
    timed cold, rotating over the model's layers' expert weights."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_grouped_weights
    E = cfg.n_experts
    worst, timed, plans = 0.0, {}, {}

    def check(args, kw, live, label):
        got = GM.dpa_grouped_matmul_fused(*args, **kw)
        want = GM.dpa_grouped_matmul_fused_ref(*args, **kw)
        torch.cuda.synchronize()
        err = _held(f"dpa_grouped_matmul_fused {label} {kw['fmt_w']}", got,
                    want)
        dropped = torch.cat([got[e, n:].reshape(-1)
                             for e, n in enumerate(live)])
        if bool((dropped != 0).any()):
            raise AssertionError(
                f"dpa_grouped_matmul_fused {label} {kw['fmt_w']}: "
                f"{int((dropped != 0).sum())} nonzero outputs on dropped rows")
        return err, dropped.numel()

    shapes = sorted(set(_expert_shapes(cfg).values()))
    for K, N in shapes:
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        prep = prep_grouped_weights(w, cfg.policy)
        prep8 = prep_grouped_weights(w, "fp8_dpa_fused")
        for M, live in ((8, [4] * (E - 2) + [1, 0]),
                        (11, [11] * (E - 3) + [7, 3, 0])):
            x = torch.randn((E, M, K), generator=gen, device="cuda")
            x = _drop(x, live).to(torch.bfloat16)
            args = (x, prep["wq"], prep["sw"])
            label = f"E={E} K={K} N={N} M={M}"
            err, n_drop = check(args, FP4_FUSED, live, label)
            err8, _ = check((x, prep8["wq"], prep8["sw"]), FP8_FUSED, live,
                            label)
            worst = max(worst, err, err8)
            plan = DM.fused_plan(E, M, K, N)
            plans[f"{K}x{N} M={M}"] = plan._asdict()
            t = timings(lambda: GM.dpa_grouped_matmul_fused(*args,
                                                            **FP4_FUSED),
                        lambda: GM.dpa_grouped_matmul_fused_ref(*args,
                                                                **FP4_FUSED))
            nbytes = (x.numel() * 2 + prep["wq"].numel()
                      + prep["sw"].numel() * 4 + E * M * N * 4)
            t["bound_ms"], b_by = bound(nbytes, 2.0 * E * M * K * N)
            timed[(K, N, M)] = t
            print(f"dpa_grouped_matmul_fused {label}: {_plan_str(plan)}; "
                  f"max_abs_err {err:.3g} (fp8 weights {err8:.3g}), {n_drop} "
                  f"dropped-row outputs all 0; {fmt_times(t)} bound_ms "
                  f"{t['bound_ms']:.5f} ({b_by})")
        if (K, N) != shapes[0]:
            continue
        for M in RAGGED_M:
            live = [M] * (E - 3) + [M // 2, 1, 0]
            x = _drop(torch.randn((E, M, K), generator=gen, device="cuda"),
                      live).to(torch.bfloat16)
            for kw, p_ in ((FP4_FUSED, prep), (FP8_FUSED, prep8)):
                err, _ = check((x, p_["wq"], p_["sw"]), kw, live,
                               f"E={E} K={K} N={N} M={M}")
                worst = max(worst, err)
                print(f"dpa_grouped_matmul_fused E={E} K={K} N={N} M={M} "
                      f"{kw['fmt_w']} weights: "
                      f"{_plan_str(DM.fused_plan(E, M, K, N))}; max_abs_err "
                      f"{err:.3g}; dropped rows 0")
        x = torch.randn((E, 64, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        rows_invariant(f"dpa_grouped_matmul_fused E={E} K={K} N={N}",
                       GM.dpa_grouped_matmul_fused, x,
                       (prep["wq"], prep["sw"]), FP4_FUSED)
    per_layer = _per_layer(timed, _expert_shapes(cfg), 8)
    per_layer["plans"] = plans
    per_layer["cold"] = cold_fused_layer(GM.dpa_grouped_matmul_fused,
                                         _expert_shapes(cfg), (E,), 8,
                                         cfg.n_layers, gen)
    print(f"dpa_grouped_matmul_fused: 3 launches per layer per model call; "
          f"one decode layer (M=8), warm: {fmt_times(per_layer)}, cold "
          f"{per_layer['cold']['device_ms']} (device), bound "
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


def _library_call(xq, wq, sx, sw):
    """One PyTorch call computing the prequant product on the same codes
    and scales (`torch._scaled_mm`, or `torch._scaled_grouped_mm` for an
    expert stack; bf16 out, the only output rowwise scaling takes), as a
    function of no arguments, or (None, why) where there is none."""
    import torch
    grouped = xq.ndim == 3
    fn_name = "_scaled_grouped_mm" if grouped else "_scaled_mm"
    if not hasattr(torch, fn_name):
        return None, f"none: torch {torch.__version__} has no {fn_name}"
    x8, w8 = _e4m3_operands(xq, wq)
    sa = torch.nn.functional.pad(sx.reshape(*sx.shape[:-2], -1),
                                 (0, x8.shape[-2] - xq.shape[-2]))
    if grouped:
        sb = sw.reshape(sw.shape[0], -1).contiguous()
        return (lambda: torch._scaled_grouped_mm(
            x8, w8, sa.contiguous(), sb, out_dtype=torch.bfloat16)), fn_name
    return (lambda: torch._scaled_mm(
        x8, w8, scale_a=sa.reshape(-1, 1).contiguous(),
        scale_b=sw.contiguous(), out_dtype=torch.bfloat16)), fn_name


def library_prequant(xq, wq, sx, sw, want):
    """The library call of `_library_call`: -> (ms, device ms, max_abs_err
    vs the plain version, note), timed as `timings` times a kernel."""
    call, fn_name = _library_call(xq, wq, sx, sw)
    if call is None:
        return None, None, None, fn_name
    try:
        out = call()
    except (RuntimeError, TypeError, ValueError) as e:   # a yardstick only
        return (None, None, None,
                f"none: torch.{fn_name} refused ({str(e)[:120]})")
    err = float((out[..., :want.shape[-2], :].float() - want).abs().max())
    return (median_ms(call), device_ms(call), err,
            f"torch.{fn_name}, bf16 out (outputs up to "
            f"{float(want.abs().max()):.4g})")


# the prequant kernels' operands: packed E2M1 on both sides
FP4_PACKED = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True,
                  pack_w=True)
# tile edges of the prequant kernel's launch plan, checked untimed
PREQUANT_EDGE_ROWS = (1, 16, 17, 64)
# packed bytes whose two codes are both +-6 (E2M1 codes 0x7 and 0xF)
SIX_BYTES = (0x77, 0x7F, 0xF7, 0xFF)
# path B walks this many layers' weights between two calls of one matrix
COLD_LAYERS = 24


def check_prequant(cfg, gen):
    """The prequant kernels, dense at the attention projections and
    grouped at the experts, on random packed-fp4 codes with random
    positive scales: M = 8 is `generate`'s decode step (2 live rows,
    padded), M = 11 a prefill chunk's expert capacity, M = 1, 16, 17 and
    64 the launch plan's row-tile edges; then every code at +-6, and the
    largest |acc| the plan admits (K = 2^16 - 128, all +6 x all -6).
    Kernel and plain version must agree exactly.  M = 8 and 11 are timed
    warm (one call repeated: the weights sit in L2), and one decode layer
    also cold, rotating over `COLD_LAYERS` layers' weights."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    E = cfg.n_experts
    kw = FP4_PACKED

    def codes(*shape, choices=None):
        if choices is None:
            return torch.randint(0, 256, shape, generator=gen, device="cuda",
                                 dtype=torch.int32).to(torch.uint8)
        idx = torch.randint(0, len(choices), shape, generator=gen,
                            device="cuda")
        return torch.tensor(choices, dtype=torch.uint8, device="cuda")[idx]

    def scales(*shape):
        return torch.rand(shape, generator=gen, device="cuda") + 0.05

    def check(kern, ref, args, label):
        got = kern(*args, **kw)
        want = ref(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if err != 0.0 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{kern.__name__} {label}: max err {err} "
                                 "!= 0")
        return want, err

    out = {}
    for what, shapes, lead in (("dense", _attn_shapes(cfg), ()),
                               ("grouped", _expert_shapes(cfg), (E,))):
        kern = DM.dpa_matmul_prequant if not lead else \
            GM.dpa_grouped_matmul_prequant
        ref = DM.dpa_matmul_prequant_ref if not lead else \
            GM.dpa_grouped_matmul_prequant_ref
        n_e = E if lead else 1
        worst, timed, lib = 0.0, {}, {}
        for K, N in sorted(set(shapes.values())):
            wq, sw = codes(*lead, K // 2, N), scales(*lead, 1, N)
            for M in (8, 11) + PREQUANT_EDGE_ROWS:
                xq, sx = codes(*lead, M, K // 2), scales(*lead, M, 1)
                if lead:
                    xq = _drop(xq, [max(1, M // 2)] * (E - 1) + [0])
                args = (xq, wq, sx, sw)
                label = f"{'E=%d ' % E if lead else ''}K={K} N={N} M={M}"
                want, err = check(kern, ref, args, label)
                worst = max(worst, err)
                plan = DM.prequant_plan(n_e, M, K, N)
                line = (f"{kern.__name__} {label}: plan bn {plan.bn} split "
                        f"{plan.split} rows {plan.row_tile} ({plan.blocks} "
                        f"blocks); max_abs_err {err:.3g}")
                if M not in (8, 11):
                    print(line)
                    continue
                t = timings(lambda: kern(*args, **kw),
                            lambda: ref(*args, **kw))
                nbytes = (xq.numel() + sx.numel() * 4 + wq.numel()
                          + sw.numel() * 4 + n_e * M * N * 4)
                t["bound_ms"], b_by = bound(nbytes, 2.0 * n_e * M * K * N)
                timed[(K, N, M)] = t
                lib_ms, lib_dev, lib_err, note = library_prequant(*args, want)
                lib[(K, N, M)] = (lib_ms, lib_dev)
                print(f"{line}; {fmt_times(t)} bound_ms {t['bound_ms']:.5f}"
                      f" ({b_by}); library {note}"
                      + (f" {lib_ms:.4f} ms (device {lib_dev}), "
                         f"max_abs_err {lib_err:.3g}"
                         if lib_ms is not None else ""))
            args = (codes(*lead, 8, K // 2, choices=SIX_BYTES),
                    codes(*lead, K // 2, N, choices=SIX_BYTES),
                    scales(*lead, 8, 1), sw)
            _, err = check(kern, ref, args, f"K={K} N={N} codes +-6")
            print(f"{kern.__name__} K={K} N={N} M=8, every code +-6: "
                  f"max_abs_err {err:.3g}")
        per_layer = _per_layer(timed, shapes, 8)
        for i, key in enumerate(("library_ms", "library_device_ms")):
            libs = [lib[(K, N, 8)][i] for K, N in shapes.values()]
            per_layer[key] = None if None in libs else sum(libs)
        per_layer["max_abs_err"] = worst
        per_layer["plans"] = {
            f"{K}x{N}": DM.prequant_plan(n_e, 8, K, N)._asdict()
            for K, N in sorted(set(shapes.values()))}
        print(f"{kern.__name__}: {len(shapes)} launches per layer per model "
              f"call; one decode layer (M=8), warm: {fmt_times(per_layer)}, "
              f"bound {per_layer['bound_ms']:.5f} ms, library "
              f"{per_layer['library_ms']} ms (device "
              f"{per_layer['library_device_ms']})")
        per_layer["cold"] = cold_prequant_layer(kern, shapes, lead, codes,
                                                scales)
        out[what] = per_layer

    # the largest |acc| the plan admits: 144 K / 4 at K = 2^16 - 128
    K = DM.K_EXACT - DM.BK
    xq = torch.full((8, K // 2), 0x77, dtype=torch.uint8, device="cuda")
    wq = torch.full((K // 2, 64), 0xFF, dtype=torch.uint8, device="cuda")
    sx, sw = scales(8, 1), scales(1, 64)
    got = DM.dpa_matmul_prequant(xq, wq, sx, sw, **kw)
    exact = torch.full_like(got, -36.0 * K) * sx * sw
    if not torch.equal(got, exact):
        raise AssertionError(f"dpa_matmul_prequant K={K}, acc {-36 * K}: "
                             f"max err {float((got - exact).abs().max())}")
    print(f"dpa_matmul_prequant K={K} M=8 N=64, all +6 x all -6 (acc "
          f"{-36 * K}): equal to (acc * sx) * sw; plan "
          f"{DM.prequant_plan(1, 8, K, 64)}")
    return out


def sweep_prequant_plans(gen, M=8):
    """Every launch (bn, split) the kernel takes at path B's prequant
    shapes (M = 8; dense K x N 1024 x 1024 and 1024 x 512, grouped E 32
    at 1024 x 512 and 512 x 1024), through the C entry point (not the
    wrapper: these launches are no path's), each held to the plain
    version and timed on the device: the evidence for `prequant_plan`."""
    import torch
    from repro_torch.kernels import build as B
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    lib = B.load_library()
    res = {}
    for E, K, N in ((1, 1024, 1024), (1, 1024, 512), (32, 1024, 512),
                    (32, 512, 1024)):
        xq = torch.randint(0, 256, (E, M, K // 2), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        wq = torch.randint(0, 256, (E, K // 2, N), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        sx = torch.rand((E, M, 1), generator=gen, device="cuda") + 0.05
        sw = torch.rand((E, 1, N), generator=gen, device="cuda") + 0.05
        want = GM.dpa_grouped_matmul_prequant_ref(xq, wq, sx, sw,
                                                  **FP4_PACKED)
        out = torch.empty_like(want)
        times = {}
        for bn in DM.COL_TILES:
            for split in range(1, DM.MAX_CLUSTER + 1):
                if (K // DM.BK) % split:
                    continue

                def call(bn=bn, split=split):
                    B.check(lib.dpa_prequant_launch(
                        xq.data_ptr(), sx.data_ptr(), wq.data_ptr(),
                        sw.data_ptr(), out.data_ptr(), E, M, K, N, bn, split,
                        torch.cuda.current_stream().cuda_stream),
                        "dpa_prequant_launch")
                out.fill_(float("nan"))
                call()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise AssertionError(f"prequant E={E} K={K} N={N} bn {bn}"
                                         f" split {split}: differs from the "
                                         "plain version")
                times[f"bn{bn}/s{split}"] = device_ms(call)
        plan = DM.prequant_plan(E, M, K, N)
        res[f"E{E} {K}x{N}"] = {"plan": f"bn{plan.bn}/s{plan.split}",
                                "device_us": {k: None if v is None else
                                              v * 1e3
                                              for k, v in times.items()}}
        print(f"prequant plans E={E} K={K} N={N} M={M} (device us; the plan "
              f"takes bn{plan.bn}/s{plan.split}): " + ", ".join(
                  f"{k} {'not measured' if v is None else f'{v * 1e3:.2f}'}"
                  for k, v in times.items()))
    return res


def cold_prequant_layer(kern, shapes, lead, codes, scales, M=8,
                        layers=COLD_LAYERS):
    """One decode layer of a prequant wrapper and of its library call,
    rotating over `layers` layers' distinct weight codes, as path B walks
    them (`cold_layer`)."""
    kcalls, lcalls = [], []
    xs = {name: (codes(*lead, M, K // 2), scales(*lead, M, 1))
          for name, (K, N) in shapes.items()}
    for _ in range(layers):
        for name, (K, N) in shapes.items():
            x, sx = xs[name]
            args = (x, codes(*lead, K // 2, N), sx, scales(*lead, 1, N))
            kcalls.append(lambda a=args: kern(*a, **FP4_PACKED))
            lcalls.append(_library_call(*args)[0])
    return cold_layer(kern.__name__, M, layers, kcalls, lcalls)


def cold_layer(name, M, layers, kcalls, lcalls=()):
    """Time `layers` decode layers' calls in order, each matrix read again
    only after every other layer's (for the stacks here, 24-36 x 25-50
    MB, far past the 50 MB L2), and the library's calls likewise where
    there are any.  -> per layer: event ms and device ms (with its
    source) of the kernel and of the library call."""
    def run(calls):
        def go():
            for c in calls:
                c()
        return go

    dev, src = device_ms_from(run(kcalls), n=3)
    res = {"layers": layers, "ms": median_ms(run(kcalls), n=5) / layers,
           "device_ms": _per(dev, layers), "device_from": src,
           "library_ms": None, "library_device_ms": None}
    if lcalls and None not in lcalls:
        try:
            res["library_ms"] = median_ms(run(lcalls), n=5) / layers
            res["library_device_ms"] = _per(device_ms(run(lcalls), n=3),
                                            layers)
        except (RuntimeError, TypeError, ValueError) as e:  # a yardstick
            print(f"  library refused ({str(e)[:120]})")
    print(f"{name}: one decode layer (M={M}), cold (rotating over {layers} "
          f"layers' weights): {res['ms']:.4f} ms (device {res['device_ms']},"
          f" {src}), library {res['library_ms']} ms (device "
          f"{res['library_device_ms']})")
    return res


def _per(v, n):
    return None if v is None else v / n


def _attn_inputs(gen, H, KV, S, hd, dtype):
    import torch
    q = torch.randn((1, H, S, hd), generator=gen, device="cuda")
    k = torch.randn((1, KV, S, hd), generator=gen, device="cuda")
    v = torch.randn((1, KV, S, hd), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _attn_work(H, KV, S, hd, elem_bytes):
    """(bytes, operations) of one causal attention call: q, k, v read and
    the output written once; QK^T and PV over the live (q, k) pairs."""
    nbytes = elem_bytes * hd * S * (2 * H + 2 * KV)
    return nbytes, 4.0 * H * hd * S * (S + 1) / 2


def _library_sdpa(q, k, v, want):
    """One PyTorch call for the same f32 attention (causal, GQA), TF32 off:
    -> (ms, device ms, max_abs_err vs the plain version, note)."""
    import torch
    sdpa = torch.nn.functional.scaled_dot_product_attention
    call = lambda: sdpa(q, k, v, is_causal=True,  # noqa: E731
                        enable_gqa=True)
    try:
        out = call()
    except (RuntimeError, TypeError, ValueError) as e:   # a yardstick only
        return None, None, None, f"none: sdpa refused ({str(e)[:120]})"
    err = float((out - want).abs().max())
    return (median_ms(call), device_ms(call), err,
            "torch.nn.functional.scaled_dot_product_attention(is_causal, "
            "enable_gqa), f32")


def check_flash(gen):
    """The f32 flash kernel against the plain global-softmax version: one
    layer of qwen3-4b's prefill (B 1, S 4096, H 32, KV 8, hd 128) on f32
    inputs at FLASH_F32_RTOL relative to the largest output, and on bf16
    inputs (the split-bf16 tensor-core instance path C runs) within one
    bf16 ulp over that f32 tolerance; hd 64 (H 16, KV 8, S 1024) and S
    1000 (bq = bk = 125) on f32.  Both dtypes timed at the first shape,
    each beside its bound: the kernel's bf16 products at the bf16
    tensor-core peak (three exact ones for bf16 inputs, six for f32),
    with the f32 peak's beside it; the library's f32 attention on the
    same values, and (bf16) bf16 SDPA as a speed reference.  -> the bf16
    instance's timings, the f32 instance's under "f32"."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import _fit_block
    worst, res = 0.0, {}
    for H, KV, S, hd, dtype in ((32, 8, 4096, 128, torch.float32),
                                (32, 8, 4096, 128, torch.bfloat16),
                                (16, 8, 1024, 64, torch.float32),
                                (32, 8, 1000, 128, torch.float32)):
        q, k, v = _attn_inputs(gen, H, KV, S, hd, dtype)
        b = _fit_block(128, S)
        got = FA.flash_attention(q, k, v, bq=b, bk=b)
        want = FA.flash_attention_ref(q, k, v)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            rel = float(err.max() / want.abs().max())
            ok, what = rel <= FLASH_F32_RTOL, f"relative {rel:.3g}"
        else:
            # one bf16 ulp of each output (8 significant bits), over the f32
            # tolerance of the sums before the rounding: near-zero outputs
            # have ulps far below the f32 noise of a 4096-term average
            ulp = _bf16_ulp(want.float())
            ok = bool((err <= ulp + FLASH_F32_RTOL
                       * float(want.float().abs().max())).all())
            what = (f"{int((err > 0).sum())} of {err.numel()} outputs "
                    f"differ, {int((err > ulp).sum())} by more than one "
                    "bf16 ulp")
        if not ok or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention H={H} S={S} hd={hd} "
                                 f"{dtype}: max err {float(err.max())} "
                                 f"({what})")
        worst = max(worst, float(err.max()))
        print(f"flash_attention H={H} KV={KV} S={S} hd={hd} bq=bk={b} "
              f"{dtype}: max_abs_err {float(err.max()):.3g}, {what}")
        if S != 4096:
            continue
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        args = (q, k, v)
        t = timings(lambda: FA.flash_attention(*args),
                    lambda: FA.flash_attention_ref(*args))
        nbytes, ops = _attn_work(H, KV, S, hd, q.element_size())
        t["f32_bound_ms"] = bound(nbytes, ops, F32_OPS_PER_S)[0]
        products = 3 if name == "bf16" else 6
        t["bound_ms"], t["bound_by"] = bound(nbytes, products * ops,
                                             FP16_OPS_PER_S)
        if name == "bf16":
            fq, fk, fv = q.float(), k.float(), v.float()
            lib_ms, lib_dev, lib_err, note = _library_sdpa(fq, fk, fv,
                                                           want.float())
            ref_ms, ref_dev, ref_note = _library_sdpa_bf16(q, k, v)
            t["speed_references"] = {"sdpa_bf16_ms": ref_ms,
                                     "sdpa_bf16_device_ms": ref_dev,
                                     "sdpa_bf16": ref_note}
            note += " on the same values upcast (casts not timed)"
        else:
            lib_ms, lib_dev, lib_err, note = _library_sdpa(q, k, v, want)
        t.update(library_ms=lib_ms, library_device_ms=lib_dev)
        print(f"flash_attention S={S} {name}: {fmt_times(t)} bound_ms "
              f"{t['bound_ms']:.4f} ({t['bound_by']}, {products} bf16 "
              f"products; f32 peak {t['f32_bound_ms']:.4f}); library {note} "
              f"{lib_ms} ms "
              f"(device {lib_dev}), max_abs_err {lib_err}"
              + (f"; speed reference bf16 SDPA {ref_ms} ms (device "
                 f"{ref_dev})" if name == "bf16" else ""))
        res[name] = t
    out = res["bf16"]
    out["f32"] = res["f32"]
    out["max_abs_err"] = worst
    return out


def _bf16_ulp(want):
    """One bf16 ulp (8 significant bits) of each f32 value in `want`."""
    import torch
    _, e = torch.frexp(want)
    return torch.ldexp(torch.ones_like(want), e - 8)


def _dpa_flash_misses(err, want, codes, v, live):
    """-> (outputs past their bound, flipped p codes).  Each output may be
    off by one bf16 ulp of itself plus FLASH_F32_RTOL of its row's largest
    output.  A flipped code moves its probability by |p0 - p1| <= the gap
    of the two E4M3 values / 448 (p <= 1, scale amax / 448), and moves the
    row's output by at most twice that times max |V| (once through acc,
    once through l >= 1): that is added to its row's bound.  Codes are
    compared where `live` ((Sq, Sk) bool) holds: a masked key's code is 0,
    or 448 in a block before the row's first live key, which alpha = 0
    wipes later — the kernel skips the key blocks that hold only such
    codes (a sliding window's), and leaves their codes 0."""
    import torch
    tol = _bf16_ulp(want) \
        + FLASH_F32_RTOL * want.abs().amax(dim=-1, keepdim=True)
    flipped = (codes[0] != codes[1]) & live
    flips = int(flipped.sum())
    if flips:
        idx = flipped.nonzero(as_tuple=True)
        gap = (codes[0][idx].view(torch.float8_e4m3fn).float()
               - codes[1][idx].view(torch.float8_e4m3fn).float()).abs()
        moved = torch.zeros(err.shape[:-1], device=err.device)
        moved.index_put_(idx[:-1], gap / 448.0, accumulate=True)
        tol = tol + 2.0 * float(v.float().abs().max()) * moved[..., None]
    return int((err > tol).sum()), flips


def _library_sdpa_bf16(q, k, v):
    """A speed reference, not the same function: bf16
    scaled_dot_product_attention (causal, GQA) on the same q, k, v.
    -> (ms, device ms, note)."""
    sdpa = __import__("torch").nn.functional.scaled_dot_product_attention
    call = lambda: sdpa(q, k, v, is_causal=True,  # noqa: E731
                        enable_gqa=True)
    try:
        call()
    except (RuntimeError, TypeError, ValueError) as e:   # a yardstick only
        return None, None, f"sdpa refused ({str(e)[:120]})"
    return (median_ms(call), device_ms(call),
            "torch.nn.functional.scaled_dot_product_attention(is_causal, "
            "enable_gqa), bf16")


def check_dpa_flash(gen):
    """The DPA flash kernel (`csrc/dpa_flash.cu`) against its plain
    version (the same key-block loop): raw mode at one layer of qwen3-4b's
    scoring (B 1, S 4096, H 32, KV 8, hd 128, bf16, K/V on the fp4 grid:
    the wrapper's pre-pass, then the kernel on packed codes), then fp8 K/V
    raw, cache mode (packed and unpacked fp4, fp8 codes) at hd 64 and at
    S 1000, and a sliding window of 300 keys at S 2048.  Both sides write every probability's E4M3 code: at most
    DPA_FLASH_MAX_FLIPS of the live codes may differ, and every output is
    held to its own bound (`_dpa_flash_misses`), which is one bf16 ulp
    where no code flipped.  Cache rows made from the same K/V give the raw
    mode's bits.  Timed at the first case, pre-pass included (and alone),
    beside the fp8 and fp16 operations bounds and, as a speed reference,
    bf16 `scaled_dot_product_attention` on the same inputs."""
    import torch
    from repro_torch.core import kvcache as KVC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import _fit_block
    worst, out, flips_per_case = 0.0, None, {}
    cases = (("raw fp4", 32, 8, 4096, 128, "fp4_e2m1", False, False),
             ("raw fp8", 16, 8, 1024, 64, "fp8_e4m3", False, False),
             ("cache packed fp4", 32, 8, 1000, 128, "fp4_e2m1", True, True),
             ("cache fp4", 16, 8, 1024, 64, "fp4_e2m1", True, False),
             ("cache fp8", 32, 8, 1000, 128, "fp8_e4m3", True, False),
             ("raw fp4 window 300", 32, 8, 2048, 128, "fp4_e2m1", False,
              False))
    for name, H, KV, S, hd, fmt_kv, cache, packed in cases:
        window = 300 if "window" in name else None
        q, k, v = _attn_inputs(gen, H, KV, S, hd, torch.bfloat16)
        b = _fit_block(128, S)
        kw = dict(fmt="fp8_e4m3", fmt_kv=fmt_kv, bq=b, bk=b, window=window)
        if cache:
            kc, ks = KVC.quantize_kv(k, fmt=fmt_kv, packed=packed)
            vc, vs = KVC.quantize_kv(v, fmt=fmt_kv, packed=packed)
            args = (q, kc, vc, ks, vs)
            kw.update(kv_quant=True, kv_packed=packed)
        else:
            args = (q, k, v)
        ref_kw = {x: y for x, y in kw.items() if x != "bq"}   # bk only
        codes = [torch.zeros((1, H, S, S), dtype=torch.uint8, device="cuda")
                 for _ in range(2)]
        got = FA.dpa_flash_attention(*args, p_codes=codes[0], **kw)
        want = FA.dpa_flash_attention_ref(*args, p_codes=codes[1], **ref_kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        mask = FA._mask(S, S, True, window, "cuda")
        live = H * int(mask.sum())
        bad, flips = _dpa_flash_misses(err, want.float(), codes, v, mask)
        if not bool(torch.isfinite(got).all()) or bad or \
                flips > DPA_FLASH_MAX_FLIPS * live:
            raise AssertionError(f"dpa_flash_attention {name} S={S} hd={hd}"
                                 f": {bad} outputs off their bound (max "
                                 f"err {float(err.max())}), {flips} of "
                                 f"{live} p codes flipped")
        if cache:
            raw = FA.dpa_flash_attention(q, k, v, fmt="fp8_e4m3",
                                         fmt_kv=fmt_kv, bq=b, bk=b)
            if not torch.equal(raw, got):
                raise AssertionError(f"dpa_flash_attention {name}: cache "
                                     "rows gave other bits than raw K/V")
        del codes
        worst = max(worst, float(err.max()))
        flips_per_case[name] = [flips, live]
        print(f"dpa_flash_attention {name} H={H} KV={KV} S={S} hd={hd} "
              f"bq=bk={b}: max_abs_err {float(err.max()):.3g}, "
              f"{int((err > 0).sum())} of {err.numel()} outputs differ; "
              f"{flips} of {live} live p codes flipped"
              + ("; == raw mode bit for bit" if cache else ""))
        if out is None:
            t = timings(lambda: FA.dpa_flash_attention(*args, **kw),
                        lambda: FA.dpa_flash_attention_ref(*args, **ref_kw))
            nbytes, ops = _attn_work(H, KV, S, hd, 2)
            t["bound_ms"], t["bound_by"] = bound(nbytes, ops)
            t["fp16_bound_ms"] = bound(nbytes, ops, FP16_OPS_PER_S)[0]
            # this design runs PV twice (p split into two fp16 pieces)
            t["fp16_bound_pv_twice_ms"] = bound(nbytes, 1.5 * ops,
                                                FP16_OPS_PER_S)[0]
            t["live_logits"] = live     # each an expf and an IEEE division
            pre = lambda: (FA._prepass(k, fmt_kv),  # noqa: E731
                           FA._prepass(v, fmt_kv))
            t["prepass_ms"] = median_ms(pre)
            t["prepass_device_ms"] = device_ms(pre)
            made = [c for x in pre() for c in x]   # K and V codes, scales
            t["prepass_bound_ms"] = bound(
                2 * k.numel() * 2 + sum(c.numel() * c.element_size()
                                        for c in made), 0.0)[0]
            sd_ms, sd_dev, note = _library_sdpa_bf16(q, k, v)
            t["speed_references"] = {"sdpa_bf16_ms": sd_ms,
                                     "sdpa_bf16_device_ms": sd_dev,
                                     "sdpa_bf16": note}
            print(f"dpa_flash_attention S={S} raw fp4 K/V: {fmt_times(t)} "
                  f"(pre-pass alone {t['prepass_ms']:.4f}, device "
                  f"{t['prepass_device_ms']}, bound "
                  f"{t['prepass_bound_ms']:.5f}); bound_ms "
                  f"{t['bound_ms']:.5f} ({t['bound_by']}, fp8 peak; fp16 "
                  f"{t['fp16_bound_ms']:.5f}, PV twice "
                  f"{t['fp16_bound_pv_twice_ms']:.5f}); {live} live logits;"
                  f" library none; speed reference {note}: {sd_ms} ms "
                  f"(device {sd_dev})")
            out = t
    out["max_abs_err"] = worst
    out["flips"] = flips_per_case
    return out


# every instance of the row quantizers: the formats of quantize_rows and
# the packed E2M1 of quantize_pack_rows
QUANT_FMTS = ("fp8_e4m3", "fp8_e5m2", "fp4_e2m1", "packed", "fp16", "bf16",
              "fp32")
# (M, K): qwen3-4b's d_model and d_ff rows of a 4096-token prompt, path
# D's K/V pre-pass (hd 128) and granite's head rows (hd 64), a ragged K
# and an odd one (scalar route; the packed form needs an even K), and two
# rows past what a block holds (the reread routes: vector, then scalar)
QUANT_SHAPES = ((4096, 2560), (4096, 9728), (32768, 128), (32768, 64),
                (130, 334), (130, 335), (64, 65544), (64, 16386))
# timed: (M, K, formats), bf16 x
QUANT_TIMED = ((4096, 9728, ("fp8_e4m3", "packed")),
               (32768, 128, ("packed", "fp8_e4m3")))


def check_quantizers(gen):
    """Both row quantizers against their plain versions, every instance
    (`QUANT_FMTS`) on f32 and bf16 x at `QUANT_SHAPES` with an all-zero
    row and a row of E2M1 ties, and on an offset (not 16-byte aligned)
    view: codes and scales must be identical bytes; each case's launch
    plan is printed.  Timed
    (`QUANT_TIMED`): qwen3-4b's MLP activations (4096 x 9728) to E4M3
    (quantize_rows) and packed E2M1 (quantize_pack_rows), and path D's
    pre-pass shape (32,768 x 128) in both, each beside its byte bound."""
    import torch
    from repro_torch.kernels import quantize as QZ

    def same(a, b):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))

    def calls(fmt):
        if fmt == "packed":
            return QZ.quantize_pack_rows, QZ.quantize_pack_rows_ref, {}
        return QZ.quantize_rows, QZ.quantize_rows_ref, {"fmt": fmt}

    def check(x, what):
        M, K = x.shape
        plan = QZ.quantize_plan(M, K, x.dtype, "fp8_e4m3",
                                aligned=x.data_ptr() % 16 == 0)
        done = []
        for fmt in QUANT_FMTS:
            if fmt == "packed" and K % 2:
                continue
            fn, ref, kw = calls(fmt)
            (gq, gs), (wq, ws) = fn(x, **kw), ref(x, **kw)
            torch.cuda.synchronize()
            if not (same(gq, wq) and same(gs, ws)):
                raise AssertionError(f"{fn.__name__} {fmt} {what}: codes or "
                                     "scales differ from the plain version")
            done.append(fmt)
        print(f"quantize {what}: route {plan.route} (lanes {plan.lanes}, "
              f"rows {plan.rows}, nv {plan.nv}, tiles {plan.tiles}); "
              f"{', '.join(done)}: codes and scales identical "
              "(max_abs_err 0)")
        return plan.route

    def planted(x):
        """Row 7 all zeros; row 8 every E2M1 threshold and its neighbours
        in x's dtype, both signs, beside its amax 6 (scale 1.0 to E2M1)."""
        bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        th = torch.tensor([0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0],
                          dtype=x.dtype, device="cuda")
        near = [th, (th.view(bits) + 1).view(x.dtype),
                (th.view(bits) - 1).view(x.dtype)]
        ties = torch.cat(near + [-t for t in near] + [
            torch.full((1,), 6.0, dtype=x.dtype, device="cuda")])
        x[7:9] = 0
        x[8, :ties.numel()] = ties
        return x

    routes = {}
    for xdt in (torch.float32, torch.bfloat16):
        tag = "f32" if xdt == torch.float32 else "bf16"
        for M, K in QUANT_SHAPES:
            x = planted((torch.randn((M, K), generator=gen, device="cuda")
                         * 3).to(xdt))
            routes[f"{M}x{K} {tag}"] = check(x, f"M={M} K={K} {tag}")
        flat = (torch.randn((1024 * 2560 + 1,), generator=gen,
                            device="cuda") * 3).to(xdt)
        routes[f"offset 1024x2560 {tag}"] = check(
            planted(flat[1:].view(1024, 2560)),
            f"M=1024 K=2560 {tag}, offset view")
    del x, flat

    out = {"routes": routes, "formats": list(QUANT_FMTS)}
    for M, K, fmts in QUANT_TIMED:
        x = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(
            torch.bfloat16)
        for fmt in fmts:
            fn, ref, kw = calls(fmt)
            gq, gs = fn(x, **kw)
            t = timings(lambda: fn(x, **kw), lambda: ref(x, **kw))
            nbytes = x.numel() * 2 + gq.numel() * gq.element_size() \
                + gs.numel() * 4
            t["bound_ms"], t["bound_by"] = bound(nbytes, 0.0)
            t["max_abs_err"] = 0.0
            t["plan"] = QZ.quantize_plan(M, K, x.dtype, "fp4_e2m1").route
            print(f"{fn.__name__} {fmt} M={M} K={K} bf16: {fmt_times(t)} "
                  f"bound_ms {t['bound_ms']:.5f} ({t['bound_by']}); "
                  "library none")
            key = fn.__name__ if K == 9728 else f"{fn.__name__}.prepass"
            out[key] = t
    return out


# -----------------------------------------------------------------------------
# phase 3: the engine at full width
# -----------------------------------------------------------------------------

def teacher_forced(model, params, req, s_ctx, chunk):
    """Step the static contiguous-cache path over the engine's own token
    timeline and compare its argmax with each engine token.  The prompt
    runs in the engine's padded `chunk`-token prefill calls, so its MoE
    capacity (computed per call) and its first logits are the engine's
    own computation; after it the paths differ only in decode attention
    (the paged kernel against the contiguous plain version).  Where they
    differ, the static logits' top-1/top-2 margin says whether they split
    a near-tie (numerics) or disagree outright (a fault)."""
    import numpy as np
    import torch
    toks = torch.from_numpy(req.tokens().astype(np.int64)).to("cuda")[None]
    n0 = req.n_prompt
    caches = model.init_caches(1, s_ctx)
    for c0 in range(0, n0, chunk):
        n = min(chunk, n0 - c0)
        x = torch.zeros((1, chunk), dtype=torch.int64, device="cuda")
        x[0, :n] = toks[0, c0:c0 + n]
        logits, caches = model.decode_step(params, {"tokens": x, "index": c0},
                                           caches)
    rows = [logits[0, n - 1]]
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
    res = {"agree": int(agree.sum()), "tokens": req.max_new,
           "first_token_agrees": bool(agree[0]),
           "worst_margin_where_differ": worst,
           "median_margin": float(np.median(margin)), "logit_scale": scale}
    print(f"request {req.rid}: teacher-forced agreement {res['agree']}/"
          f"{req.max_new} (first token {'equal' if agree[0] else 'differs'});"
          f" largest static top-2 margin where they differ {worst:.3g} "
          f"(median margin {res['median_margin']:.3g}, logit scale "
          f"{scale:.3g})")
    return res


def zero_counts():
    from repro_torch.kernels import counters
    counters.zero()


def read_counts() -> dict:
    """Every kernel wrapper's launch counter and its route counters
    (`repro_torch.kernels.counters`; a graph replay adds its capture's
    delta)."""
    from repro_torch.kernels import counters
    return counters.snapshot()


def check_counts(what, got, want):
    """Every kernel's launches over one path equal the count its config
    and run imply (0 for the kernels the path does not run)."""
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what} launches {got}, want {want}")
    print(f"launches on the {what} path: " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))


# the watched kernels' names in a profile, and the counters whose
# launches each name stands for
REPLAY_KERNELS = {
    "dpa_fused_kernel": ("dpa_matmul_fused", "dpa_grouped_matmul_fused"),
    "paged_decode": ("paged_decode_attention",),
    "dpa_prequant_kernel": ("dpa_matmul_prequant",
                            "dpa_grouped_matmul_prequant")}


# small kernels launched before a retried window's replay (see
# check_replay)
REPLAY_PADS = (0, 3, 17, 61, 5, 29, 113, 251)


def check_replay(label, graph):
    """One profiler window over a single replay of a captured step: each
    watched kernel runs as often as the capture's counter delta says, so
    the counts on the graphed paths rest on the trace, not on the
    arithmetic alone.  The profiler now and then loses a kernel record,
    the same one in each identical window of a run (on an H100 the
    granite prefill chunk's replay read 166-167 of 168 fused launches in
    one to four windows in a row; eager windows, whose counts the
    wrappers make exact, lost up to 3 of 252).  So a window that does not match is tried
    again after a few small kernels (`REPLAY_PADS`), which move the
    records in the profiler's buffers; one window must equal the delta,
    else the check fails.  -> the first window's profile (its times are
    the replay's alone), with the pads of the matching one."""
    import torch
    want = {w: sum(graph.delta[c] for c in cs)
            for w, cs in REPLAY_KERNELS.items()}
    pad = torch.zeros((), device="cuda")
    seen, first = [], None
    for k in REPLAY_PADS:
        def fn(k=k):
            for _ in range(k):
                pad.add_(1)
            return graph.run()
        prof = profile_window(
            f"{label} (one replay" + (f", after {k} small kernels)" if k
                                      else ")"),
            fn, watch=tuple(REPLAY_KERNELS), require=True,
            timed=0 if k else 5)
        first = first or prof
        got = {w: v["launches"] for w, v in prof["watch"].items()}
        if got == want:
            print(f"  {label}: one replay's kernels {got} = the capture's "
                  "delta")
            return dict(first, matched_after_pads=k)
        seen.append(got)
    raise AssertionError(f"{label}: the profiler saw {seen} kernels in "
                         f"{len(REPLAY_PADS)} replays, the capture counted "
                         f"{want}")


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
    one device flag, in place, so a captured step ANDs in at every
    replay; -> restore (which returns the flag)."""
    import torch
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step_fn = model.decode_step

    def checked_step(p, batch, caches):
        logits, caches = step_fn(p, batch, caches)
        finite.logical_and_(torch.isfinite(logits).all())
        return logits, caches

    model.decode_step = checked_step

    def restore():
        model.decode_step = step_fn
        return bool(finite)
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


def _report_line(rep) -> str:
    return (f"{rep['n_requests']} requests, {rep['gen_tokens']} tokens in "
            f"{rep['wall_s']:.2f} s = {rep['tokens_per_s']:.2f} tok/s; "
            f"{rep['prefill_calls']} prefill calls, {rep['decode_steps']} "
            f"decode steps, {rep['steps']} ticks; TTFT p50 "
            f"{rep['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
            f"{rep['p50_latency_s'] * 1e3:.0f} ms p99 "
            f"{rep['p99_latency_s'] * 1e3:.0f} ms")


def _capture_line(name, st) -> str:
    return (f"  capture of the {name}: warm-up {st['warmup_s']:.2f} s, "
            f"capture {st['capture_s']:.2f} s; the pool took "
            f"{st['pool_bytes'] / 1e6:.1f} MB, the graph keeps "
            f"{st['kept_bytes'] / 1e6:.2f} MB; max allocated "
            f"{st['max_allocated_before'] / 1e9:.3f} -> "
            f"{st['max_allocated_after'] / 1e9:.3f} GB")


SERVE_ORDER = ("eager", "graphed", "graphed", "eager")


def run_engine(cfg, ecfg):
    """The engine over 8 requests eagerly (`graphs=False`, the reference)
    and with its steps as CUDA graphs, in turns (`SERVE_ORDER`): every
    request's tokens equal in every run, the launch counts the config
    implies on each run, and one profiler window over a single replay of
    each graph of the first graphed run holding its kernels to the
    capture's counts.  The first run of each mode is the one reported
    (the graphed one's counts are the path's), beside every run's
    tokens/s."""
    import numpy as np
    import torch
    from repro_torch.launch.engine import Engine, synthetic_workload
    from repro_torch.launch.serve import generate

    model, params = build(cfg)
    restore = finite_steps(model)
    dense, experts = per_call_projections(cfg)
    reps, served = {"eager": [], "graphed": []}, []
    for mode in SERVE_ORDER:
        reqs = synthetic_workload(8, vocab=cfg.vocab_size, seed=0, rate=0,
                                  prompt_range=(64, 192), gen_range=(16, 32))
        t0 = time.monotonic()
        engine = Engine(model, params, ecfg, device="cuda",
                        graphs=mode == "graphed")
        torch.cuda.synchronize()
        setup_s = time.monotonic() - t0
        zero_counts()
        rep = engine.run(reqs)
        torch.cuda.synchronize()
        counts = read_counts()
        for r in reqs:
            if r.n_generated != r.max_new:
                raise AssertionError(f"request {r.rid}: {r.n_generated} of "
                                     f"{r.max_new} tokens")
        if engine.alloc.in_use != 0 or np.any(engine._table != 0):
            raise AssertionError("pages not evicted / table not back to "
                                 "scratch")
        calls = rep["prefill_calls"] + rep["decode_steps"]
        check_counts(f"{cfg.name} engine ({mode})", counts, {
            "dpa_matmul_fused": dense * cfg.n_layers * calls,
            "dpa_matmul_fused.splitk": dense * cfg.n_layers * calls,
            "dpa_grouped_matmul_fused": experts * cfg.n_layers * calls,
            "dpa_grouped_matmul_fused.splitk": experts * cfg.n_layers * calls,
            "paged_decode_attention": cfg.n_layers * rep["decode_steps"]})
        print(f"  = {dense * cfg.n_layers} dense"
              + (f" + {experts * cfg.n_layers} grouped" if experts else "")
              + f" per model call x {calls} calls, {cfg.n_layers} paged per "
              f"decode step x {rep['decode_steps']} steps")
        rep["setup_s"] = setup_s
        print(f"engine ({mode}): {cfg.name} {_report_line(rep)}; set-up "
              f"{setup_s:.2f} s (not in the wall)")
        for name, st in rep.get("capture", {}).items():
            print(_capture_line(name, st))
        reps[mode].append(rep)
        served.append(reqs)
        if mode == "graphed" and len(reps[mode]) == 1:
            rep["replay_check"] = {
                "decode step": check_replay(f"{cfg.name} decode step",
                                            engine._decode),
                "prefill chunk": check_replay(f"{cfg.name} prefill chunk",
                                              engine._prefill)}
            rep["counts"] = counts
        del engine
    if not restore():
        raise AssertionError("non-finite logits")
    for i, run in enumerate(served[1:], 1):
        differ = [a.rid for a, b in zip(served[0], run)
                  if a.out_tokens != b.out_tokens]
        if differ:
            raise AssertionError(f"{cfg.name}: run {i} ({SERVE_ORDER[i]}) "
                                 "gave other tokens than the eager run 0 "
                                 f"for requests {differ}")
    rep, reqs = reps["graphed"][0], served[SERVE_ORDER.index("graphed")]
    print(f"{cfg.name}: every request's tokens equal in all "
          f"{len(SERVE_ORDER)} runs ({' '.join(SERVE_ORDER)}; "
          f"{rep['gen_tokens']} tokens each)")
    counts = rep.pop("counts")
    rep["eager"] = reps["eager"][0]
    rep["tokens_per_s_runs"] = {m: [r["tokens_per_s"] for r in rs]
                                for m, rs in reps.items()}
    if cfg.is_moe:
        moe_repeatable(params, cfg)
        want = {"moe_experts": cfg.n_experts, "moe_top_k": cfg.top_k,
                "moe_grouped_route": "cuda_grouped_fused",
                "moe_grouped_backend": "cuda",
                "expert_w_reduction_vs_f32": 8.0}
        bad = {k: rep.get(k) for k, v in want.items() if rep.get(k) != v}
        if bad or not rep.get("moe_grouped_bytes_per_step_layer"):
            raise AssertionError(f"moe report fields {bad}")
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

    # greedy agreement with `generate` on the card, reported: its one-call
    # prefill of the whole prompt takes the tiled route from 128 tokens on
    # and, for a MoE model, other expert capacities than the engine's
    # 32-token chunks, and random weights leave near-tied logits.  The
    # teacher-forced replay runs the engine's own prefill calls, so the
    # first token must be the engine's; after it only decode attention
    # differs, which splits near-ties: a wrong page, position or cache row
    # would leave next to no token in agreement, so at least half must
    # agree (the margins where they differ are reported beside)
    rep["agreement"] = []
    for r in reqs[:2]:
        out = generate(model, params, r.prompt[None], r.max_new, ecfg.s_max,
                       device="cuda")
        same = np.asarray(r.out_tokens) == out[0, r.n_prompt:].cpu().numpy()
        first = int(np.argmin(same)) if not same.all() else r.max_new
        print(f"request {r.rid}: engine vs generate greedy agreement "
              f"{int(same.sum())}/{r.max_new}, identical up to token "
              f"{first}")
        tf = teacher_forced(model, params, r, ecfg.s_max, ecfg.prefill_chunk)
        if not tf["first_token_agrees"] or 2 * tf["agree"] < tf["tokens"]:
            raise AssertionError(f"request {r.rid}: teacher-forced replay "
                                 f"{tf}")
        rep["agreement"].append({
            "rid": r.rid, "n_prompt": r.n_prompt, "greedy_agree":
            int(same.sum()), "identical_up_to": first, "teacher_forced": tf})
    return model, params, rep, counts


def run_generate(cfg, params, *, n_prompts=2, prompt_len=32, n_new=16):
    """Static greedy serving (`generate`) under cfg's policy, over params
    built for the same model (the weights prepared again for the policy),
    eagerly (`graphs=False`, the reference) and with the serve step as a
    CUDA graph: the same tokens, the launch counters over each run (the
    graphed run's one warm-up call is its step 0), finite logits, the
    output's shape and range; then one serve step profiled eager and
    graphed, and one replay held to its capture's counts."""
    import torch
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.launch.graphs import Step, StepGraph
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    model = build_model(cfg, device="cuda")
    params = model.prepare_params(params)
    restore = finite_steps(model)
    prompt = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len),
                           generator=torch.Generator().manual_seed(2))
    s_ctx = prompt_len + n_new
    calls = s_ctx - 1
    dense, experts = per_call_projections(cfg)
    outs, res = {}, {}
    for mode in ("eager", "graphed"):
        zero_counts()
        t0 = time.monotonic()
        out = generate(model, params, prompt, n_new, s_ctx, device="cuda",
                       graphs=mode == "graphed")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        if tuple(out.shape) != (n_prompts, s_ctx) or not bool(
                ((out >= 0) & (out < cfg.vocab_size)).all()) or \
                not torch.equal(out[:, :prompt_len].cpu(),
                                prompt.to(torch.int32)):
            raise AssertionError(f"generate returned {tuple(out.shape)} "
                                 f"{out.dtype}")
        check_counts(f"{cfg.name} generate ({cfg.policy}, {mode})", counts, {
            "dpa_matmul_prequant": dense * cfg.n_layers * calls,
            "dpa_grouped_matmul_prequant": experts * cfg.n_layers * calls})
        print(f"  = {dense * cfg.n_layers} dense + {experts * cfg.n_layers} "
              f"grouped per model call x {calls} calls")
        # graphed: per replayed call, without the capture and step 0 (its
        # warm-up call, eager)
        st = generate.capture_stats
        timed = calls - 1 if st else calls
        step_wall = wall - (st["warmup_s"] + st["capture_s"] if st else 0.0)
        res[mode] = {"wall_s": wall, "model_calls": calls,
                     "ms_per_call": step_wall / timed * 1e3, "capture": st}
        print(f"generate ({mode}): {cfg.name} {n_prompts} prompts x "
              f"{prompt_len} tokens + {n_new} new in {wall:.2f} s ({calls} "
              f"model calls, {res[mode]['ms_per_call']:.1f} ms each"
              + (" of the replayed ones" if st else "") + ")")
        if st:
            print(_capture_line("serve step", st))
        outs[mode] = out.cpu()
        if mode == "graphed":
            res[mode]["counts"] = counts
    if not restore():
        raise AssertionError("non-finite logits")
    if not torch.equal(outs["eager"], outs["graphed"]):
        raise AssertionError(f"graphed generate tokens "
                             f"{outs['graphed'].tolist()} differ from the "
                             f"eager run's {outs['eager'].tolist()}")
    print(f"generate: graphed tokens equal the eager run's; new tokens "
          f"{outs['graphed'][:, prompt_len:].tolist()}")

    # phase 4: one serve step as generate makes its last one, eager and
    # as a replay of its graph
    caches = model.init_caches(n_prompts, s_ctx)
    serve_step = make_serve_step(model)

    def step(tokens, index):
        return serve_step(params, {"tokens": tokens, "index": index},
                          caches)[0]

    bufs = {"tokens": prompt[:, :1].to("cuda"),
            "index": torch.full((), s_ctx - 2, dtype=torch.int32,
                                device="cuda")}
    label = f"{cfg.name} serve step (B={n_prompts}, {cfg.policy})"
    prof = {"eager": profile_window(f"{label}, eager",
                                    Step(step, bufs).run,
                                    watch=("dpa_prequant_kernel",), timed=3)}
    graph = StepGraph(step, bufs, name="serve step")
    print(_capture_line("serve step (profiled)", graph.stats))
    prof["graphed"] = check_replay(f"{label}, graphed", graph)
    res["graphed"]["profile"] = prof
    counts = res["graphed"].pop("counts")
    return counts, {**res["graphed"], "eager": res["eager"]}


def _prompt(cfg, S, seed):
    import torch
    return torch.randint(0, cfg.vocab_size, (1, S),
                         generator=torch.Generator().manual_seed(seed)
                         ).to("cuda")


@contextlib.contextmanager
def recorded_attention(calls):
    """Inside, every `models.layers._sdpa` call appends its (q, k, v, out)
    to `calls`, in the (B, S, heads, hd) layout the model hands over."""
    from repro_torch.models import layers
    inner = layers._sdpa

    def record(q, k, v, **kw):
        out = inner(q, k, v, **kw)
        calls.append((q, k, v, out))
        return out

    layers._sdpa = record
    try:
        yield
    finally:
        layers._sdpa = inner


def check_path_attention(what, calls, plain, kernel=None):
    """Each layer's attention output on a path (`recorded_attention`)
    against `plain`, the kernel's plain version, on the same inputs laid
    out heads-first here and not by the route.  Pins what lies between
    the model and the kernel: the route's transposes, blocks and
    arguments.  -> (the largest error, flipped p codes per layer).

    f32 route (`kernel` None): one bf16 ulp of each output plus
    FLASH_F32_RTOL of the layer's largest.  DPA route: `kernel(q, k, v,
    p_codes)` runs again on the layer's inputs with its probability codes
    recorded, and must give the route's output bit for bit; the plain
    version records its codes too, and the layer is held to phase 2's
    bound (`_dpa_flash_misses`, at most DPA_FLASH_MAX_FLIPS of its live
    codes flipped), one layer at a time (a code buffer is H x S x S
    bytes)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    worst, flips = 0.0, []
    codes = None
    for i, (q, k, v, out) in enumerate(calls):
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        got = out.transpose(1, 2)
        if kernel is None:
            want = plain(qh, kh, vh).float()
            err = (got.float() - want).abs()
            tol = _bf16_ulp(want) + FLASH_F32_RTOL * float(want.abs().max())
            bad = int((err > tol).sum())
        else:
            B, H, S, _ = qh.shape
            if codes is None:
                codes = [torch.zeros((B, H, S, S), dtype=torch.uint8,
                                     device=q.device) for _ in range(2)]
                mask = FA._mask(S, kh.shape[2], True, None, q.device)
            for c in codes:
                c.zero_()
            again = kernel(qh, kh, vh, codes[0])
            if not torch.equal(again, got):
                raise AssertionError(f"{what}: layer {i}'s kernel output "
                                     "differs from the route's on the same "
                                     "inputs")
            want = plain(qh, kh, vh, codes[1]).float()
            err = (got.float() - want).abs()
            bad, n = _dpa_flash_misses(err, want, codes, vh, mask)
            live = H * S * (S + 1) // 2
            flips.append(n)
            if n > DPA_FLASH_MAX_FLIPS * live:
                raise AssertionError(f"{what}: layer {i}: {n} of {live} p "
                                     "codes flipped")
        if got.shape != want.shape or bad:
            raise AssertionError(f"{what}: layer {i}'s attention is "
                                 f"{float(err.max())} off the plain version"
                                 f" ({bad} outputs past their bound)")
        worst = max(worst, float(err.max()))
    del codes
    if kernel is None:
        print(f"{what}: {len(calls)} layers' attention outputs within one "
              f"bf16 ulp of the plain version (max |diff| {worst:.3g})")
    else:
        print(f"{what}: {len(calls)} layers' attention outputs within "
              f"phase 2's bound of the plain version (max |diff| "
              f"{worst:.3g}); p codes flipped per layer {flips} (budget "
              f"{DPA_FLASH_MAX_FLIPS:g} of each layer's live codes)")
    return worst, flips


def run_prefill(cfg, params, S=4096):
    """Path C: `make_prefill_step` over one S-token prompt under cfg's own
    policy (fp8_dpa) with use_flash, on params built for the engine (the
    masters serve the fake-quant linears): every layer's attention through
    the f32 flash kernel and nothing else.  One call warms up, the next is
    timed (the time to the first token) and counted.  Against the same
    call with use_flash off (f32 logits, softmax rounded to bf16 before
    PV, as the reference's route rounds it): the last position's logits
    and greedy token, reported; 36 layers of fp8 fake-quant activations
    amplify the routes' rounding differences, so these logits are only
    required to stay correlated (cosine >= 0.95).  What they cannot see,
    the wiring between model and kernel, is held per layer: every
    layer's attention output against the plain version on its inputs
    (`check_path_attention`)."""
    import torch
    from repro_torch.distributed.step import make_prefill_step
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda")
    params = model.prepare_params(params)
    step = make_prefill_step(model)
    tokens = _prompt(cfg, S, 4)
    step(params, tokens)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    logits, caches = step(params, tokens)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    del caches
    check_counts(f"{cfg.name} prefill ({cfg.policy}, use_flash)", counts,
                 {"flash_attention": cfg.n_layers})
    ref, caches = make_prefill_step(build_model(
        cfg.replace(use_flash=False), device="cuda"))(params, tokens)
    del caches
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        logits.reshape(1, -1), ref.reshape(1, -1)))
    tok, ref_tok = int(logits[0, -1].argmax()), int(ref[0, -1].argmax())
    top = torch.topk(ref[0, -1], 2).values
    if cos < 0.95:
        raise AssertionError(f"prefill logits decorrelated from the f32 "
                             f"route: cosine {cos}, max diff {err}")
    calls = []
    with recorded_attention(calls):
        step(params, tokens)
    layer_err, _ = check_path_attention(
        "prefill", calls, lambda q, k, v: FA.flash_attention_ref(q, k, v))
    del calls
    print(f"prefill: {cfg.name} {S}-token prompt in {wall:.3f} s (time to "
          f"the first token); first greedy token {tok} (use_flash off: "
          f"{ref_tok}, its top-2 margin {float(top[0] - top[1]):.3g}); "
          f"last-position logits vs use_flash off: max |diff| {err:.4g}, "
          f"logit scale {scale:.4g}, cosine {cos:.6f}")
    prof = profile_window(f"{cfg.name} prefill ({S} tokens)",
                          lambda: step(params, tokens))
    return counts, {"wall_s": wall, "first_token": tok, "ref_token": ref_tok,
                    "max_abs_diff_vs_ref_attn": err, "logit_scale": scale,
                    "cosine_vs_ref_attn": cos,
                    "attn_max_abs_err_vs_plain": layer_err,
                    "profile": prof}


def run_scoring(cfg, params, S=4096):
    """Path D: the forward of `make_loss_fn` over one S-token sequence
    under w4a8_kv4_attn8 with use_flash (logits_chunk divides S: the
    chunked cross-entropy over backbone_features): every layer's attention
    through the DPA flash kernel on raw K/V (after the wrapper's pre-pass,
    two row-quantizer launches), every projection through the fused matmul
    kernel.  Warm-up, then a timed and counted call.  Against use_flash off
    (global-max p quantization): a small, nonzero loss difference, within
    SCORING_REF_TOL.  Every layer's attention output against the plain
    version on its inputs, with the p codes flipped counted
    (`check_path_attention`)."""
    import math
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.step import make_loss_fn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import FLASH_BLOCK
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda")
    params = model.prepare_params(params)
    loss_fn = make_loss_fn(model)
    pol = get_policy(cfg.policy)
    prepass = ("quantize_pack_rows" if pol.fmt_kv == "fp4_e2m1"
               else "quantize_rows")
    batch = {"tokens": _prompt(cfg, S, 5), "labels": _prompt(cfg, S, 6)}
    loss_fn(params, batch)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    total, parts = loss_fn(params, batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    dense, _ = per_call_projections(cfg)
    check_counts(f"{cfg.name} scoring ({cfg.policy}, use_flash)", counts,
                 {"dpa_flash_attention": cfg.n_layers,
                  "dpa_flash_attention.prepass": cfg.n_layers,
                  prepass: 2 * cfg.n_layers,
                  "dpa_matmul_fused": dense * cfg.n_layers,
                  "dpa_matmul_fused.tiled": dense * cfg.n_layers,
                  "dpa_act_quant": dense * cfg.n_layers})
    ref_total, ref_parts = make_loss_fn(build_model(
        cfg.replace(use_flash=False), device="cuda"))(params, batch)
    loss, ref_loss = float(parts["loss"]), float(ref_parts["loss"])
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(loss) and 0.5 * ln_v < loss < 1.5 * ln_v
            and abs(loss - ref_loss) <= SCORING_REF_TOL
            and float(parts["aux"]) == 0.0):
        raise AssertionError(f"scoring loss {loss} (use_flash off "
                             f"{ref_loss}, limit {SCORING_REF_TOL}; ln V "
                             f"{ln_v:.4f}), aux {float(parts['aux'])}")
    print(f"scoring: {cfg.name} {S} tokens, loss {loss:.6f} (use_flash off "
          f"{ref_loss:.6f}, diff {loss - ref_loss:.3g}; ln V {ln_v:.4f}) in "
          f"{wall:.3f} s = {S / wall:.1f} tokens/s")
    calls = []
    with recorded_attention(calls):
        loss_fn(params, batch)
    kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, bk=FLASH_BLOCK)
    layer_err, layer_flips = check_path_attention(
        "scoring", calls,
        lambda q, k, v, c: FA.dpa_flash_attention_ref(q, k, v, p_codes=c,
                                                      **kw),
        kernel=lambda q, k, v, c: FA.dpa_flash_attention(
            q, k, v, p_codes=c, bq=FLASH_BLOCK, **kw))
    del calls
    prof = profile_window(f"{cfg.name} scoring ({S} tokens)",
                          lambda: loss_fn(params, batch))
    return counts, {"wall_s": wall, "tokens_per_s": S / wall, "loss": loss,
                    "loss_ref_attn": ref_loss, "loss_diff": loss - ref_loss,
                    "attn_max_abs_err_vs_plain": layer_err,
                    "attn_p_codes_flipped_per_layer": layer_flips,
                    "profile": prof}


def run_quantize_op(gen, M=4096, K=9728):
    """The `quantize_pack` op (`kernels.ops.quantize_rows`) on one
    prompt's MLP activations (bf16 (4096, 9728)): packed E2M1, E4M3, E5M2
    and f32 codes, each held to the plain route exactly."""
    import torch
    from repro_torch.core import exec_plan
    from repro_torch.kernels import ops
    x = (torch.randn((M, K), generator=gen, device="cuda") * 3).to(
        torch.bfloat16)
    plain = exec_plan.route("quantize_pack", "torch_quantize")
    cases = (("fp4_e2m1", True), ("fp8_e4m3", False), ("fp8_e5m2", False),
             ("fp32", False))
    zero_counts()
    got = [ops.quantize_rows(x, fmt, pack=pack) for fmt, pack in cases]
    torch.cuda.synchronize()
    counts = read_counts()
    check_counts("quantize_pack op", counts,
                 {"quantize_pack_rows": 1, "quantize_rows": 3})
    for (q, s), (fmt, pack) in zip(got, cases):
        wq, ws = plain.run(x, fmt=fmt, pack=pack)
        if not (torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
                and torch.equal(s, ws)):
            raise AssertionError(f"quantize_pack {fmt} pack={pack}: differs "
                                 "from the plain route")
    print(f"quantize_pack op: ({M}, {K}) bf16 -> packed E2M1, E4M3, E5M2 "
          "and f32 codes, all identical to the plain route")
    return counts


# -----------------------------------------------------------------------------
# phase 4: where the time goes (torch.profiler over one decode step and one
# prefill chunk of the full-width engine)
# -----------------------------------------------------------------------------

def profile_engine(model, params, ecfg):
    """One steady decode step (4 live requests; the scheduler's host work,
    the step and its token read-back) and one 32-token prefill chunk,
    each profiled on an eager engine and on a graphed one."""
    import torch
    from repro_torch.launch.engine import DECODE, Engine, synthetic_workload

    out = {}
    for mode in ("eager", "graphed"):
        engine = Engine(model, params, ecfg, device="cuda",
                        graphs=mode == "graphed")
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
            "prefill chunk (32 tokens)": lambda: engine._prefill(
                tokens=chunk, index=0),
        }
        out[mode] = {name: profile_window(f"{model.cfg.name} {name}, {mode}",
                                          fn, watch=("dpa_fused_kernel",
                                                     "paged_decode"),
                                          timed=3)
                     for name, fn in windows.items()}
        del engine
    return out


def profile_window(label, fn, watch=(), require=False, timed=0):
    """torch.profiler over one call of fn after a warm-up call: wall time,
    device busy time and share, launches, the top kernels by device
    time, and for each name in `watch` the device time and share of the
    kernels whose names contain it.  A session that records no device
    activity (short ones sometimes do not) is tried again, up to four
    times; with `require` a fourth empty one fails.  With `timed`, also
    the median host wall of that many calls outside the profiler (its
    tracing stretches the gaps between a graph's kernels), each ended by
    a synchronize, and the busy share against it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    by_name = {}
    for e in kernels:
        dt = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
    busy = sum(by_name.values())
    if not kernels:
        if require:
            raise AssertionError(f"profile {label}: four sessions saw no "
                                 "device events")
        print(f"profile {label}: wall {wall_ms:.1f} ms; the profiler saw no "
              "device events (busy share not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None,
                "unprofiled_wall_ms": None}
    bare_ms = None
    if timed:
        walls = []
        for _ in range(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        bare_ms = sorted(walls)[len(walls) // 2]
    print(f"profile {label}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.2f} ms ({busy / wall_ms:.1%}), {len(kernels)} kernel "
          "launches" + ("" if bare_ms is None else
                        f"; unprofiled wall {bare_ms:.2f} ms (busy "
                        f"{busy / bare_ms:.1%})"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    for kname, ms in top:
        print(f"    {ms:8.3f} ms  {kname[:100]}")
    watched = {}
    for w in watch:
        ms = sum(v for k, v in by_name.items() if w in k)
        n = sum(1 for e in kernels if w in e.name)
        watched[w] = {"ms": ms, "share": ms / busy, "launches": n}
        print(f"    {w}: {ms:.3f} ms in {n} launches, {ms / busy:.1%} of "
              "device busy time")
    return {"wall_ms": wall_ms, "busy_ms": busy, "launches": len(kernels),
            "unprofiled_wall_ms": bare_ms,
            "top": [[k[:100], v] for k, v in top], "watch": watched}


def serving_summary(engines, gen):
    """One line per serving step and mode: wall, device busy and share,
    launches; engine tokens/s, TTFT and latency; path B's ms per call."""
    def prof_str(p):
        if p.get("busy_ms") is None:
            return f"wall {p['wall_ms']:.2f} ms, busy not measured"
        bare = p["unprofiled_wall_ms"]
        return (f"wall {bare:.2f} ms unprofiled, {p['wall_ms']:.2f} "
                f"profiled; device busy {p['busy_ms']:.2f} ms "
                f"({p['busy_ms'] / bare:.1%} of the unprofiled wall, "
                f"{p['busy_ms'] / p['wall_ms']:.1%} of the profiled); "
                f"{p['launches']} launches")
    for name, (rep, prof) in engines.items():
        for mode in ("eager", "graphed"):
            r = rep if mode == "graphed" else rep["eager"]
            runs = ", ".join(f"{v:.2f}"
                             for v in rep["tokens_per_s_runs"][mode])
            print(f"summary {name} engine {mode}: {r['tokens_per_s']:.2f} "
                  f"tok/s (runs: {runs}), TTFT p50 "
                  f"{r['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
                  f"{r['p50_latency_s'] * 1e3:.0f} ms p99 "
                  f"{r['p99_latency_s'] * 1e3:.0f} ms")
            for window, p in prof[mode].items():
                print(f"summary {name} {window} {mode}: {prof_str(p)}")
        for step, p in rep["replay_check"].items():
            print(f"summary {name} {step}, one replay alone: "
                  f"{prof_str(p)}")
    for mode in ("eager", "graphed"):
        r = gen if mode == "graphed" else gen["eager"]
        print(f"summary granite-moe-1b-a400m generate {mode}: "
              f"{r['ms_per_call']:.2f} ms per model call")
        print(f"summary granite-moe-1b-a400m serve step {mode}: "
              f"{prof_str(gen['profile'][mode])}")


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
    from repro_torch.kernels.dpa_matmul import TILED_MIN_M
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
    mm_err, mm_t = check_matmul(qwen, gen, _dense_shapes(qwen),
                                qwen.n_layers)
    gmm_err, gmm_t = check_matmul(granite, gen, _dense_shapes(granite),
                                  granite.n_layers)
    tl_err, tl_t = check_fused_tiled(qwen, gen, _dense_shapes(qwen))
    fused_sweep = sweep_fused_plan(gen)
    splitk_plans = sweep_splitk_plans(gen)
    pd_err, pd_t = check_paged(qwen, pol, gen, ecfg)
    gpd_err, gpd_t = check_paged(granite, pol, gen, ecfg)
    gf_err, gf_t = check_grouped_fused(granite, gen)
    pq_t = check_prequant(granite, gen)
    pq_plans = sweep_prequant_plans(gen)
    fa_t = check_flash(gen)
    dfa_t = check_dpa_flash(gen)
    qz_t = check_quantizers(gen)
    gc.collect()
    torch.cuda.empty_cache()
    t_kernels = time.monotonic() - t_start

    # phase 3a / 4: qwen3-4b through the engine, eager and graphed
    model, params, rep_q, n_q = run_engine(qwen, ecfg)
    prof_q = profile_engine(model, params, ecfg)
    del model
    t_engine_q = time.monotonic() - t_start
    # phase 3d: qwen3-4b's long-prompt prefill under its own policy
    # (fp8_dpa) with use_flash, on the engine's params
    n_c, pre_c = run_prefill(get_config("qwen3-4b").replace(use_flash=True),
                             params)
    # phase 3e: full-sequence scoring under w4a8_kv4_attn8 with use_flash
    n_d, score_d = run_scoring(qwen.replace(use_flash=True), params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_qwen = time.monotonic() - t_start

    # phase 3b / 4: granite-moe-1b through the engine (path A), eager and
    # graphed
    model, params, rep_g, n_g = run_engine(granite, ecfg)
    prof_g = profile_engine(model, params, ecfg)
    # phase 3c / 4: granite-moe-1b through generate under fp4_dpa_packed
    # (path B), on the same weights prepared for that policy, eager and
    # graphed
    n_b, gen_b = run_generate(granite.replace(policy="fp4_dpa_packed"),
                              params)
    del model, params
    t_granite = time.monotonic() - t_start
    # phase 3f: the quantize_pack op
    n_qp = run_quantize_op(gen)
    t_total = time.monotonic() - t_start
    print(f"phase times: kernels {t_kernels:.1f} s, qwen3-4b engine "
          f"{t_engine_q - t_kernels:.1f} s, qwen3-4b prefill and scoring "
          f"{t_qwen - t_engine_q:.1f} s, granite-moe-1b "
          f"{t_granite - t_qwen:.1f} s, quantize_pack op "
          f"{t_total - t_granite:.1f} s")

    def times(t):
        return {k: t[k] for k in TIME_KEYS + ("bound_ms",)}

    def lib(t):
        return {k: t[k] for k in ("library_ms", "library_device_ms")}

    kernels = [
        {"name": "dpa_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:184",
         "launches": (n_q["dpa_matmul_fused"] + n_g["dpa_matmul_fused"]
                      + n_d["dpa_matmul_fused"]),
         "splitk_launches": (n_q["dpa_matmul_fused.splitk"]
                             + n_g["dpa_matmul_fused.splitk"]),
         "max_abs_err": max(mm_err, gmm_err, tl_err), **times(mm_t),
         "device_from": mm_t.get("device_from"),
         "bound_by": "bytes", "library_ms": None,
         "cold": mm_t["cold"], "plans": mm_t["plans"],
         "at": "qwen3-4b, one decoder layer's 7 projections at decode M=4 "
               "(padded to 8), split-K route; cold: 36 layers' weights",
         "granite": {"max_abs_err": gmm_err, **times(gmm_t),
                     "cold": gmm_t["cold"], "plans": gmm_t["plans"],
                     "at": "granite-moe-1b, one layer's 4 attention "
                           "projections at decode M=4 (padded to 8); cold: "
                           "24 layers' weights"},
         "tiled": {
             "name": "dpa_matmul_fused", "route": "cuda",
             "source": "src/repro_torch/csrc/dpa_fused_tiled.cu",
             "replaces": "src/repro/kernels/dpa_matmul.py:184",
             "launches": n_d["dpa_matmul_fused.tiled"],
             "max_abs_err": tl_err, **times(tl_t),
             "bound_by": "operations", "library_ms": None,
             "fp16_bound_ms": tl_t["fp16_bound_ms"],
             "prepass_ms": tl_t["prepass_ms"],
             "prepass_device_ms": tl_t["prepass_device_ms"],
             "speed_references": {
                 "bf16_matmul_ms": tl_t["bf16_matmul_ms"],
                 "bf16_matmul_device_ms": tl_t["bf16_matmul_device_ms"],
                 "scaled_mm_ms": tl_t["scaled_mm_ms"],
                 "scaled_mm_device_ms": tl_t["scaled_mm_device_ms"],
                 "scaled_mm": tl_t["scaled_mm"]},
             "at": "path D: one qwen3-4b layer's 7 projections at M=4096, "
                   "pre-pass included (bound at the fp8 peak)"}},
        {"name": "dpa_act_quant", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_fused_tiled.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:184",
         "launches": n_d["dpa_act_quant"],
         "max_abs_err": 0.0, **times(tl_t["prepass"]),
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no PyTorch call quantizes per (row, K block of "
                    "128) with the contract's scale in one pass",
         "at": "path D: one qwen3-4b layer's 7 projections' activations at "
               "M=4096, bf16 -> E4M3 codes and block scales"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:332",
         "launches": (n_q["paged_decode_attention"]
                      + n_g["paged_decode_attention"]),
         "max_abs_err": max(pd_err, gpd_err), **times(pd_t),
         "bound_by": pd_t["bound_by"], "library_ms": None,
         "split": pd_t["split"], "splits_device_ms": pd_t["splits_device_ms"],
         "long": pd_t["long"],
         "at": "one layer, B=4 H=32 KV=8 hd=128 page=16 lengths "
               "[256,201,101,18]; long: B=2, 2048 pages of 16, positions "
               "[32767,9000]",
         "hd64": {"max_abs_err": gpd_err, **times(gpd_t),
                  "split": gpd_t["split"],
                  "splits_device_ms": gpd_t["splits_device_ms"],
                  "long": gpd_t["long"],
                  "at": "granite-moe-1b, H=16 KV=8 hd=64, same lengths"}},
        {"name": "dpa_matmul_prequant", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_prequant.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:95",
         "launches": n_b["dpa_matmul_prequant"],
         "max_abs_err": pq_t["dense"]["max_abs_err"], **times(pq_t["dense"]),
         "bound_by": "bytes", "library_ms": pq_t["dense"]["library_ms"],
         "library_device_ms": pq_t["dense"]["library_device_ms"],
         "cold": pq_t["dense"]["cold"], "plans": pq_t["dense"]["plans"],
         "at": "granite-moe-1b, one layer's 4 attention projections at "
               "M=8 (2 rows padded)"},
        {"name": "dpa_grouped_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_grouped_matmul.py:154",
         "launches": n_g["dpa_grouped_matmul_fused"],
         "splitk_launches": n_g["dpa_grouped_matmul_fused.splitk"],
         "max_abs_err": gf_err, **times(gf_t),
         "bound_by": "bytes", "library_ms": None,
         "cold": gf_t["cold"], "plans": gf_t["plans"],
         "at": "granite-moe-1b, one layer's 3 expert matmuls (E=32) at "
               "M=8 (4 rows padded), split-K route; cold: 24 layers' "
               "expert weights"},
        {"name": "dpa_grouped_matmul_prequant", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_prequant.cu",
         "replaces": "src/repro/kernels/dpa_grouped_matmul.py:75",
         "launches": n_b["dpa_grouped_matmul_prequant"],
         "max_abs_err": pq_t["grouped"]["max_abs_err"],
         **times(pq_t["grouped"]),
         "bound_by": "bytes", "library_ms": pq_t["grouped"]["library_ms"],
         "library_device_ms": pq_t["grouped"]["library_device_ms"],
         "cold": pq_t["grouped"]["cold"], "plans": pq_t["grouped"]["plans"],
         "at": "granite-moe-1b, one layer's 3 expert matmuls (E=32) at "
               "M=8 (2 rows padded)"},
        {"name": "dpa_flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_flash.cu",
         "replaces": "src/repro/kernels/flash_attention.py:218",
         "launches": n_d["dpa_flash_attention"],
         "prepass_launches": n_d["dpa_flash_attention.prepass"],
         "max_abs_err": dfa_t["max_abs_err"], **times(dfa_t),
         "device_from": dfa_t.get("device_from"),
         "bound_by": dfa_t["bound_by"], "library_ms": None,
         "library": "none: no PyTorch call quantizes q, K/V and the "
                    "probabilities per (row, key block) inside attention",
         "fp16_bound_ms": dfa_t["fp16_bound_ms"],
         "fp16_bound_pv_twice_ms": dfa_t["fp16_bound_pv_twice_ms"],
         "live_logits": dfa_t["live_logits"],
         "prepass_ms": dfa_t["prepass_ms"],
         "prepass_device_ms": dfa_t["prepass_device_ms"],
         "prepass_bound_ms": dfa_t["prepass_bound_ms"],
         "speed_references": dfa_t["speed_references"],
         "p_codes_flipped": dfa_t["flips"],
         "path_d_p_codes_flipped_per_layer":
             score_d["attn_p_codes_flipped_per_layer"],
         "at": "one layer of qwen3-4b scoring: B=1 S=4096 H=32 KV=8 hd=128 "
               "causal, bf16, raw K/V on the fp4 grid, pre-pass included "
               "(bound at the fp8 peak)"},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:100",
         "launches": n_c["flash_attention"],
         "max_abs_err": fa_t["max_abs_err"], **times(fa_t),
         "device_from": fa_t.get("device_from"),
         "bound_by": fa_t["bound_by"], **lib(fa_t),
         "f32_bound_ms": fa_t["f32_bound_ms"],
         "speed_references": fa_t["speed_references"],
         "at": "one layer of qwen3-4b prefill: B=1 S=4096 H=32 KV=8 hd=128 "
               "causal, bf16 (path C's instance: split-bf16 tensor cores; "
               "bound: three bf16 products at the bf16 peak; library: f32 "
               "SDPA on the same values)",
         "f32": {**times(fa_t["f32"]), "bound_by": fa_t["f32"]["bound_by"],
                 **lib(fa_t["f32"]),
                 "f32_bound_ms": fa_t["f32"]["f32_bound_ms"],
                 "prepass_launches": n_c["flash_attention.prepass"],
                 "at": "the same layer in f32 (K/V split by the pre-pass, "
                       "included; six bf16 products; bound: six bf16 "
                       "products at the bf16 peak)"}},
        {"name": "quantize_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/quantize_rows.cu",
         "replaces": "src/repro/kernels/quantize.py:70",
         "launches": n_qp["quantize_rows"],
         "max_abs_err": 0.0, **times(qz_t["quantize_rows"]),
         "device_from": qz_t["quantize_rows"]["device_from"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no PyTorch call computes per-row absmax scales "
                    "and the saturating cast in one pass",
         "plan": qz_t["quantize_rows"]["plan"],
         "formats": [f for f in qz_t["formats"] if f != "packed"],
         "routes": qz_t["routes"],
         "prepass_shape": {**times(qz_t["quantize_rows.prepass"]),
                           "plan": qz_t["quantize_rows.prepass"]["plan"],
                           "at": "M=32768 K=128 bf16 -> E4M3 codes (path "
                                 "D's pre-pass shape under fp8 K/V)"},
         "at": "M=4096 K=9728 bf16 -> E4M3 codes"},
        {"name": "quantize_pack_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/quantize_rows.cu",
         "replaces": "src/repro/kernels/quantize.py:50",
         "launches": n_qp["quantize_pack_rows"] + n_d["quantize_pack_rows"],
         "max_abs_err": 0.0, **times(qz_t["quantize_pack_rows"]),
         "device_from": qz_t["quantize_pack_rows"]["device_from"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: PyTorch has no E2M1 encode or nibble pack",
         "plan": qz_t["quantize_pack_rows"]["plan"],
         "formats": ["packed fp4_e2m1"],
         "prepass_shape": {
             **times(qz_t["quantize_pack_rows.prepass"]),
             "plan": qz_t["quantize_pack_rows.prepass"]["plan"],
             "at": "M=32768 K=128 bf16 -> packed E2M1 codes (path D's K/V "
                   "pre-pass: one launch, K or V of one layer)"},
         "at": "M=4096 K=9728 bf16 -> packed E2M1 codes (launches: the "
               "quantize_pack op's and path D's K/V pre-pass)"},
    ]
    print("engine report: " + json.dumps(
        {"qwen3-4b": rep_q, "granite-moe-1b-a400m": rep_g}))
    print("generate: " + json.dumps(
        {"granite-moe-1b-a400m fp4_dpa_packed": gen_b}))
    print("prefill and scoring: " + json.dumps(
        {"qwen3-4b prefill fp8_dpa use_flash S=4096": pre_c,
         "qwen3-4b scoring w4a8_kv4_attn8 use_flash S=4096": score_d}))
    print("profile: " + json.dumps(
        {"qwen3-4b": prof_q, "granite-moe-1b-a400m": prof_g}))
    serving_summary({"qwen3-4b": (rep_q, prof_q),
                     "granite-moe-1b-a400m": (rep_g, prof_g)}, gen_b)
    print("prequant plans: " + json.dumps(pq_plans))
    print("fused plan sweep: " + json.dumps(
        {"tiled_min_m": TILED_MIN_M, "device_ms": fused_sweep}))
    print("splitk plans: " + json.dumps(splitk_plans))
    print(f"total {t_total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
