"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (every failure raises; the exit code is then non-zero):

1. Card: name and power limit, torch and CUDA versions, and the build of
   the CUDA kernels from `src/repro_torch/csrc/` (timed).
2. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes: `dpa_matmul_fused` at every projection of
   qwen3-4b (M = 4 decode, M = 32 prefill chunk) and
   `paged_decode_attention` at the engine's decode geometry plus the
   block-table edge cases (odd lengths, mid-page positions, an idle slot
   on the scratch page).  Each kernel and its plain version are timed with
   CUDA events (median of 25 runs after warm-up) beside the least time
   the card could take (bytes over 3.35 TB/s, or operations over the fp8
   peak, whichever is larger).
3. Engine: full-width qwen3-4b (36 layers, bf16, policy w4a8_kv4_attn8,
   seeded random weights) serves 8 synthetic requests through the
   continuous-batching engine.  The kernel launch counters are zeroed
   just before the run and read just after: every projection must have
   gone through the fused kernel and every decode step's attention
   through the paged kernel.
4. Where the time goes: torch.profiler over one steady decode step and
   one prefill chunk of the same engine (device busy share, top kernels).

Prints the engine report and the profile as JSON, the kernels' JSON
line, the card's name and power limit, and, as the last line,
{"ok": true, "device": {...}}.  Exits non-zero, printing
no result, without a CUDA device or without the repository's sources.
"""
from __future__ import annotations

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


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# -----------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# -----------------------------------------------------------------------------

def check_matmul(cfg, gen):
    """Every (K, N) projection of the model at M = 4 and 32, bf16 x,
    packed-fp4 weights prepared as the model prepares them (and the
    kernel's (fp8, fp8) pair at M = 32, untimed)."""
    import torch
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import (dpa_matmul_fused_pipeline,
                                         prep_weights)
    d, f = cfg.d_model, cfg.d_ff
    q_out, kv_out = cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    projections = {"wq": (d, q_out), "wk": (d, kv_out), "wv": (d, kv_out),
                   "wo": (q_out, d), "wg": (d, f), "wu": (d, f),
                   "wd": (f, d)}
    shapes = sorted(set(projections.values()))
    worst = 0.0
    per_layer = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
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
                    f"dpa_matmul_fused K={K} N={N} M={M}: max err "
                    f"{float(err.max())} over rtol {MATMUL_RTOL} / atol "
                    f"{MATMUL_ATOL}")
            ms = median_ms(lambda: DM.dpa_matmul_fused(*args, **kw))
            plain = median_ms(lambda: DM.dpa_matmul_fused_ref(*args, **kw))
            nbytes = (xp.numel() * 2 + prep["wq"].numel()
                      + prep["sw"].numel() * 4 + xp.shape[0] * N * 4)
            b_ms, b_by = bound(nbytes, 2.0 * xp.shape[0] * K * N)
            timed[(K, N, M)] = (ms, plain, b_ms)
            print(f"dpa_matmul_fused K={K} N={N} M={M}: max_abs_err "
                  f"{float(err.max()):.3g} kernel_ms {ms:.4f} plain_ms "
                  f"{plain:.3f} bound_ms {b_ms:.5f} ({b_by})")
        # the kernel's other fmt pair, (fp8, fp8) weights: checked, untimed
        prep8 = prep_weights(w.to(torch.bfloat16), "fp8_dpa_fused")
        args = (xp, prep8["wq"], prep8["sw"])
        kw = dict(fmt_x="fp8_e4m3", fmt_w="fp8_e4m3", pack_w=False)
        got = DM.dpa_matmul_fused(*args, **kw)
        want = DM.dpa_matmul_fused_ref(*args, **kw)
        err = (got - want).abs()
        if not bool((err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all()):
            raise AssertionError(f"dpa_matmul_fused fp8 weights K={K} N={N}:"
                                 f" max err {float(err.max())}")
        worst = max(worst, float(err.max()))
        print(f"dpa_matmul_fused K={K} N={N} M=32 fp8 weights: max_abs_err "
              f"{float(err.max()):.3g}")
    for K, N in projections.values():
        ms, plain, b_ms = timed[(K, N, 4)]
        per_layer["ms"] += ms
        per_layer["plain_ms"] += plain
        per_layer["bound_ms"] += b_ms
    print(f"dpa_matmul_fused: {len(projections)} launches per layer per "
          f"step, {len(projections) * cfg.n_layers} per decode step; one "
          f"decode layer (M=4): kernel {per_layer['ms']:.4f} ms, plain "
          f"{per_layer['plain_ms']:.3f} ms, bound "
          f"{per_layer['bound_ms']:.5f} ms")
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
        print(f"paged_decode_attention {name}: max_abs_err "
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

    ms = median_ms(lambda: PD.paged_decode_attention(*main_args, **kw))
    plain = median_ms(lambda: PD.paged_decode_attention_ref(*main_args,
                                                            **kw))
    q, table, pos = main_args[0], main_args[5], main_args[6]
    live_rows = sum(lengths) * cfg.n_kv_heads
    row_bytes = cfg.hd // 2 + 4                   # packed codes + scale
    # K and V live rows once, q read and out written (bf16), table, pos
    nbytes = (2 * live_rows * row_bytes + 2 * q.numel() * 2
              + table.numel() * 4 + pos.numel() * 4)
    ops = 2 * 2 * sum(lengths) * cfg.n_heads * cfg.hd
    b_ms, b_by = bound(nbytes, ops)
    print(f"paged_decode_attention B=4: kernel_ms {ms:.4f} plain_ms "
          f"{plain:.3f} bound_ms {b_ms:.6f} ({b_by}); 1 launch per layer, "
          f"{cfg.n_layers} per decode step")
    return worst, {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                   "bound_by": b_by}


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


def run_engine(cfg, ecfg):
    import numpy as np
    import torch
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.launch.engine import Engine, synthetic_workload
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model

    t0 = time.monotonic()
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model: {cfg.name} {cfg.n_layers} layers d={cfg.d_model} "
          f"policy={cfg.policy} dtype={cfg.dtype}, init + weight prep "
          f"{time.monotonic() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")

    finite = torch.ones((), dtype=torch.bool, device="cuda")
    step_fn = model.decode_step

    def checked_step(p, batch, caches):
        nonlocal finite
        logits, caches = step_fn(p, batch, caches)
        finite = finite & torch.isfinite(logits).all()
        return logits, caches

    model.decode_step = checked_step
    reqs = synthetic_workload(8, vocab=cfg.vocab_size, seed=0, rate=0,
                              prompt_range=(64, 192), gen_range=(16, 32))
    engine = Engine(model, params, ecfg, device="cuda")
    DM.dpa_matmul_fused.launches = 0
    PD.paged_decode_attention.launches = 0
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    n_mm = DM.dpa_matmul_fused.launches
    n_pd = PD.paged_decode_attention.launches
    model.decode_step = step_fn

    for r in reqs:
        if r.n_generated != r.max_new:
            raise AssertionError(f"request {r.rid}: {r.n_generated} of "
                                 f"{r.max_new} tokens")
    if engine.alloc.in_use != 0 or np.any(engine._table != 0):
        raise AssertionError("pages not evicted / table not back to scratch")
    if not bool(finite):
        raise AssertionError("non-finite logits")
    calls = rep["prefill_calls"] + rep["decode_steps"]
    want_mm = 7 * cfg.n_layers * calls
    want_pd = cfg.n_layers * rep["decode_steps"]
    if n_mm != want_mm or n_pd != want_pd:
        raise AssertionError(f"launches: fused {n_mm} (want {want_mm}), "
                             f"paged {n_pd} (want {want_pd})")
    print(f"engine: {rep['n_requests']} requests, {rep['gen_tokens']} "
          f"tokens in {rep['wall_s']:.2f} s = {rep['tokens_per_s']:.2f} "
          f"tok/s; {rep['prefill_calls']} prefill calls, "
          f"{rep['decode_steps']} decode steps, {rep['steps']} ticks; "
          f"TTFT p50 {rep['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
          f"{rep['p50_latency_s'] * 1e3:.0f} ms p99 "
          f"{rep['p99_latency_s'] * 1e3:.0f} ms")
    print(f"kv-cache: peak live {rep['live_bytes'] / 1e6:.2f} MB "
          f"({rep['peak_live_tokens']} tokens) in {rep['paged_bytes'] / 1e6:.2f}"
          f" MB of pages vs static {rep['static_bytes'] / 1e6:.2f} MB / f32 "
          f"{rep['static_f32_bytes'] / 1e6:.2f} MB; decode route "
          f"{rep['decode_route']} [{rep['decode_backend']}]")
    print(f"launches on the main path: dpa_matmul_fused {n_mm} "
          f"(= 252 x {calls}), paged_decode_attention {n_pd} "
          f"(= 36 x {rep['decode_steps']})")

    # greedy agreement with the static path on the card (printed, not
    # asserted: the paged kernel and the contiguous plain path sum in
    # different orders, and random weights leave near-tied logits)
    for r in reqs[:2]:
        out = generate(model, params, r.prompt[None], r.max_new, ecfg.s_max,
                       device="cuda")
        same = np.asarray(r.out_tokens) == out[0, r.n_prompt:].cpu().numpy()
        first = int(np.argmin(same)) if not same.all() else r.max_new
        print(f"request {r.rid}: engine vs generate greedy agreement "
              f"{int(same.sum())}/{r.max_new}, identical up to token "
              f"{first}")
        teacher_forced(model, params, r, ecfg.s_max)
    return model, params, rep, n_mm, n_pd


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
            print(f"profile {name}: wall {wall_ms:.1f} ms; the profiler "
                  "saw no device events (busy share not measured)")
            out[name] = {"wall_ms": wall_ms, "busy_ms": None}
            continue
        print(f"profile {name}: wall {wall_ms:.1f} ms, device busy "
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

    cfg = get_config("qwen3-4b").replace(policy="w4a8_kv4_attn8")
    pol = get_policy(cfg.policy)
    ecfg = EngineConfig(page_size=16, n_pages=80, max_batch=4,
                        max_pages_per_req=16, token_budget=64,
                        prefill_chunk=32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    mm_err, mm_t = check_matmul(cfg, gen)
    pd_err, pd_t = check_paged(cfg, pol, gen, ecfg)
    model, params, rep, n_mm, n_pd = run_engine(cfg, ecfg)
    prof = profile_engine(model, params, ecfg)

    kernels = [
        {"name": "dpa_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:184",
         "launches": n_mm, "max_abs_err": mm_err, "ms": mm_t["ms"],
         "plain_ms": mm_t["plain_ms"], "bound_ms": mm_t["bound_ms"],
         "bound_by": "bytes", "library_ms": None,
         "at": "one decoder layer's 7 projections at decode M=4"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:332",
         "launches": n_pd, "max_abs_err": pd_err, "ms": pd_t["ms"],
         "plain_ms": pd_t["plain_ms"], "bound_ms": pd_t["bound_ms"],
         "bound_by": pd_t["bound_by"], "library_ms": None,
         "at": "one layer, B=4 H=32 KV=8 hd=128 page=16 lengths "
               "[256,201,101,18]"},
    ]
    print(f"engine report: {json.dumps(rep)}")
    print(f"profile: {json.dumps(prof)}")
    print(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
