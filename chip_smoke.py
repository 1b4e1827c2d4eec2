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
     over the model's layers' weights;
   - its tiled route (`fused_plan` from `TILED_MIN_M` rows on: the
     pre-pass `dpa_act_quant`, then fp16 tensor cores) at M = 4096 at
     each of qwen3-4b's five projection shapes with packed-fp4 weights,
     the (fp8, fp8) pair at K x N 2560 x 1024, the threshold M and a
     ragged M (threshold + 44), and grouped at E 32, M 256, K x N 1024 x
     512; the pre-pass's codes and scales held to its plain version
     exactly; one qwen3-4b layer at M = 4096 timed, with the pre-pass
     alone, the fp8 and fp16 operations bounds and, as speed references,
     bf16 `torch.matmul` and `torch._scaled_mm` with block scales (or its
     refusal);
   - `paged_decode_attention` at the engine's decode geometry plus the
     block-table edge cases (odd lengths, mid-page positions, an idle
     slot on the scratch page) and one long context (B 2, 2,048 pages of
     16, positions 32767 and 9000, timed), for qwen3-4b (hd 128, H 32, KV
     8) and granite-moe-1b (hd 64, H 16, KV 8); at the engine's shape
     every cluster split 1-8 is checked and timed beside the launch
     plan's (`paged_plan`); its fp4 (E2M1) and fp16 attention formats
     over packed-fp4 and E4M3 KV, and fp8 over E4M3 KV, at both models'
     engine shapes and (fp4, fp16) the long context, timed; every case
     holds each output to the smaller of its format's bound
     (`PAGED_DECODE_CARD_TOLS`) and the case's own (`_paged_case_tol`,
     from its own sums of p codes: ~1e-3 at the long context); and
     the speculative verify fold (B 4 x 5 query rows in one launch at the
     decode plan's split) in each attention format, `torch.equal` to 5
     single-position launches;
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
     c walks them, for the kernel and the library call alike);
   - the TransDot datapath (`core.dpa`, `core.fpnew_ref`, `core.oracle`)
     on CUDA tensors: every batch of `tests/golden/dpa_vectors.npz`
     replayed bit for bit, seeded random batches in 8 modes (specials, a
     narrow window, sequential FMA) equal to the CPU's codes, the card's
     lanes/s in Table I's modes and the paper's numerics table (DPA vs
     sequential FMA, card = CPU); the prequant kernels, dense and grouped
     (E 2 and 32), equal to `oracle.dpa_exact` bit for bit in the fp16
     x2, E4M3 x4 and E2M1 x8 modes (windowed codes, K padded to 128) and
     E2M1 at K 2560; each new operand format (fp16, bf16, E4M3, E5M2,
     unpacked E2M1, and four mixes) at granite's shapes, M 8 and 11,
     within rtol 2e-5 / atol 2e-4 of the plain version (E2M1 x E2M1 bit
     for bit), one decode layer per format timed warm beside its bound
     and `torch.matmul` / `torch._scaled_mm`;
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
   - (phase 2m) the kernels' new formats (`check_fused_formats`,
     `check_dpa_flash_formats`; paged decode's in the two checks above):
     the fused matmul with E2M1 and fp16 activations at qwen3-4b's five
     projections, M 8 and 32 (split-K, E4M3 weights at one shape, the
     row-invariance `torch.equal`) and 4096 (tiled, the pre-pass's codes
     exact), and grouped at granite's expert shapes, within rtol 2e-5 /
     atol 2e-4; paged decode with f32 attention over E4M3, fp16, packed
     and unpacked E2M1 codes (f32 q, bound 1e-5), fp16 over fp16, E4M3
     over bf16 and E5M2, at both models' engine shapes (and the long
     context), and the verify fold in f32 over E4M3 and fp16 over fp16;
     DPA flash in fp16 and E2M1 attention at hd 128 (S 4096), hd 64 (S
     1000, bk 125) and hd 256 (path H's layer), fp16 cache codes, and
     fp16 over packed-E2M1 cache rows, within its format's flip budget
     and 0.075; each timed beside its bound at the format's peak;
   - `quantize_rows` and `quantize_pack_rows`, every instance (E4M3,
     E5M2, E2M1, packed E2M1, fp16, bf16, f32) on f32 and bf16 x, at M
     4096 x K 2560 and 9728, path D's pre-pass rows (32,768 x 128), hd 64
     rows, K 334 and 335 (the scalar route), rows past what a block holds
     (the reread routes) and an offset view, held to identical codes and
     scales, each case's launch plan printed; timed at 4096 x 9728 and
     32,768 x 128;
   - the tuner (`repro_torch.runtime.tuner`, `run_tuner`): its smoke
     space at the serving paths' shapes (qwen3-4b and granite-moe-1b at
     full width: every (bn, split) the fused and prequant routes take at
     each layer shape, the flash routes' (bq, bk) at 4096 tokens, the
     quantizers' (lanes, nv), the paged routes at the engine's geometry)
     measured into a fresh DB under `build/`, each record printed with the
     static plan marked and each (route, shape)'s tuned / static ratio;
     every tuned plan that differs from the static one held against the
     plain version once (bit for bit for the quantizers and prequant's
     int8 route, the fused route's pin, the flash routes' pins and
     DPA_FLASH_MAX_FLIPS at the tuned bk).
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
   engines three times in turns (`SERVE_ORDER`; the eager run serves the
   first `EAGER_REQUESTS`), `generate` once each way, and every request's
   tokens must be equal in every run that serves it; after the
   first graphed run one profiler window over a single replay of each
   graph must show each
   watched kernel (`dpa_fused_kernel`, `paged_decode`,
   `dpa_prequant_kernel`) as often as the capture counted; capture time
   and the graphs' pool bytes are printed:
   a. qwen3-4b (36 layers) serves 8 synthetic requests through the
      continuous-batching engine: every projection through the fused
      kernel's split-K route, every decode step's attention through the
      paged kernel; one request is replayed through `generate` and
      teacher-forced through the static path (greedy agreement and the
      top-2 margins where the paths differ, reported).  The tuner's
      engine pseudo-op (page size 8 and 16, `kv4_attn8_packed`, the same
      geometry) is measured on this model's weights, and the second
      graphed run serves with the tuner's DB active: every plan says
      "tuned", the launch counts are the untuned run's, and the tokens
      equal the untuned runs' where every tuned split is the static one
      (else the teacher-forced replay holds them);
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
      f32 codes);
   g. qwen3-4b's engine sampling (temperature 0.8, top-k 50, top-p 0.95,
      seed 7; `SAMPLED`) on a's workload, eagerly and graphed: the draw
      (threefry streams keyed on (seed, rid, position), top-k/top-p
      filter, Gumbel argmax) runs inside the captured decode step; every
      request's tokens equal in both runs; requests 1 and 6 (`ALONE`)
      served alone get their in-batch tokens; a temperature-0 config with
      seed 7 and top-k 50 gives a's greedy tokens;
   h. the prefix cache: a's workload behind a shared 128-token prefix
      (block table of 24 pages), graphed, cold (cache off) against warm
      (cache on): every request's tokens equal, the warm run skipping
      the cached pages' prefill (tokens saved, hit rate, TTFT p50 cold
      and warm printed);
   i. the front end: one `repro_torch.launch.serve.main(FRONT_END)` call
      (`python -m repro_torch.launch.serve --arch qwen3-4b --engine
      --policy w4a8_kv4_attn8 --requests 8 --prompt-len 192 --gen 32
      --temperature 0.8 --top-k 50 --top-p 0.95`: its own full-width
      model and weights), its report lines printed and checked.
   j. speculative decoding on a's engine and workload (k = 4, graphed):
      first the row-invariance probe (one 5-token verify pass against 5
      stepped decode steps from one cache state, every recorded op's
      rows `torch.equal`, the per-row split as the engine runs it: none
      may differ, and a call that differs on equal inputs is named); a
      self-draft (every draft accepted, a's greedy tokens); on a's first
      request a static w4a4_kv4_attn4 draft, on its first 2 the default
      adaptive ladder under the default controller, on the first one
      under one that switches rung every round (a's greedy tokens; each
      rung that drafted launched its attention format, all three in the
      switching run), a
      sampled adaptive run twice on the first request (both drain, equal
      tokens); one replay of each draft and verify step profiled; and one
      `launch.serve.main(FRONT_END_ADAPTIVE)` call (`--adaptive-draft`,
      its own model).
   Paths g-j run the engine's kernels only (fused split-K, paged
   decode and its verify fold); every engine run's counts are checked
   as a's, paged decode's by attention format too.
   The expected counts are computed from the config and the run; d and e
   are each compared with the same call with use_flash off, and every
   layer's attention output on them with the kernel's plain version on
   the same inputs (on e with both sides' probability codes, to phase
   2's flip-aware bound).
3m. The presets the kernels' new formats unlock, on a's weights (L,
   M, N) and b's (L):
   L. fp4_dpa_fused (packed-E2M1 weights, activations quantized onto
      E2M1 in the fused kernel): qwen3-4b and granite-moe-1b through
      `generate` (2 prompts of 32 + 16 new, eager and graphed, equal
      tokens; every projection on the split-K route, counted by
      activation format, `.fp4_e2m1`), and qwen3-4b's 4096-token scoring
      with use_flash (every projection tiled at E2M1 after its pre-pass,
      the f32 flash kernel's attention; the loss within SCORING_REF_TOL of
      use_flash off);
   M. the engine at a's geometry under kv8_attn_f32 (a's 8 requests),
      kv16_attn_f32 and attn_fp16_dpa (its first 4), 8 new tokens each,
      eager and graphed, greedy: equal tokens, every decode step's
      attention through the paged kernel in f32 or fp16 attention over
      E4M3 or fp16 codes (counted by format, the `fp32` bucket), the
      linears f32; two requests teacher-forced as in a;
   N. qwen3-4b's 4096-token scoring with use_flash under attn_fp16_dpa
      and attn_fp4_packed: every layer's attention through the DPA flash
      kernel in fp16 or E2M1 attention after its row-quantizer pre-pass,
      each layer held to the plain version at its format's flip budget
      (`DPA_FLASH_FLIP_BUDGET`) and within the route's 0.075.  (A prefill
      writes a quantized cache and attends its dequantized rows through
      the plain route, as the reference's does: DPA flash serves the
      cache-free pass.)
3k. The recurrent families at their published widths, seeded weights,
   w4a8_kv4_attn8, each model alone on the card (peak memory printed):
   first the DPA flash kernel's head-dim 256 instance against its plain
   version at path H's shape (B 1, H 16, KV 1, S 4096, window 2048, bq
   64; p-code flips within DPA_FLASH_MAX_FLIPS; timed beside the band's
   operations bound) and in cache mode at S 1000, window 300;
   G. recurrentgemma-9b (38 layers: rg, rg, attn_local x 12 and a tail
      of 2 rg; hd 256, MQA) through `generate`, 2 prompts of 32 + 16
      new, eager and graphed: equal tokens, 266 split-K fused launches a
      model call, one serve step profiled eager and as a replay;
   H. its 4096-token prefill with use_flash (12 DPA flash launches at hd
      256 with window 2048 and 24 pre-pass launches, 266 tiled fused and
      266 pre-pass launches), each layer's attention within the route's
      0.075 of `torch_dpa_attn` and within phase 2's bound of the plain
      version, the window caches = the last 2048 K/V rows; then 16
      greedy decode steps from its caches, the window sliding;
   I. xlstm-1.3b (48 layers: 7 mLSTM + 1 sLSTM x 6, no MLP) through
      `generate` as G (324 split-K launches a call), and once more
      through `launch.serve.main` (static mode, its own model).
3l. The encoder-decoder and VLM families at their published widths,
   seeded weights, w4a8_kv4_attn8 with use_flash, on the data
   pipeline's stub batches, each model alone on the card (peak memory
   printed):
   J. whisper-medium (24 encoder + 24 decoder layers, LayerNorm, GELU,
      learned positions, hd 64): `encode` of B 2 x 1,500 frames (24 DPA
      flash launches, non-causal, bq = bk = 125; 144 tiled fused
      launches at M 3,000), `prefill` of a 32-token prompt (the encoder
      again, 24 cross-attention flash launches at Sq 32 x Sk 1,500; the
      decoder's linears split-K, its cross K/V tiled) and 16 greedy
      `decode_step`s (cross K/V projected at every step: 48 tiled, 192
      split-K launches a step), the prompt stepped through decode_step
      near the prefill's logits; encoder and cross-attention layer 0
      against the plain version (flip budget), the encoder's layer-0
      linears at M 3,000 and 3,072 and decoder layer 0's ten linears in
      one decode step (split-K at M 2, the cross K/V tiled) against
      theirs; then the encoder
      under the model's own fp8_dpa (24 f32 flash launches, bf16
      instance, non-causal, hd 64), layer 0 within one bf16 ulp;
   K. pixtral-12b (40 layers, d 5,120, hd 128, 12.25 B parameters): a
      scoring `train_logits` of 4,096 stub embeddings (280 tiled fused
      launches, 40 causal DPA flash launches), layer 0's attention and
      seven linears (tiled at M 4,096) against the plain version,
      `prefill` of the same embeddings and 8 greedy token
      `decode_step`s (280 split-K launches a step), layer 0's seven
      linears of one step (split-K at M 1) against the plain version.
   Each path's launches per kernel, walls, tokens/s and profiles printed.
4. Where the time goes: torch.profiler over one steady decode step and
   one prefill chunk of each engine and one serve step of path c, each
   eager and graphed (wall, device busy share, launches; the prequant
   kernels' share on path c), over one graphed sampled decode step of
   path g beside the greedy one, and over one call of paths d and e
   (device busy share, top kernels); summary lines per step and mode.
   After each path's profile window (paths A-D, G-K and the phase 5 train
   step), where the time goes against the bound (`path_roofline`): per
   route the launches, device ms, summed bound (`kernels/census.py`, the
   launch counters' work over the window) and loss, from a window whose
   records match the counters (`matched_window`), no route's device ms
   below its bound / 1.05; and the path's analytic cell
   (`launch/roofline.py:cell_roofline`) against its wall.  On paths D and
   K the tiled route's census operations equal the analytic census's
   linear MACs exactly (`check_linear_census`).
5. Training (`repro_torch.launch.train`'s path; the train step takes the
   torch routes, and every kernel's launch counter must stay 0):
   a. one train step of reduced qwen3-4b, llama3.2-3b and granite-moe-1b
      under fp8_dpa and fp32 on the card against the same step on the
      CPU from one state and batch: loss rtol 1e-4, every gradient leaf
      and updated param leaf at relative norm 1e-3 (`TRAIN_CPU_LEAF`).
      The STE's codes, scales and operands of the two devices are
      compared (`ste_operands`, `ste_flips`) and the differences counted;
      where an operand differs, the CPU step is recomputed from the
      card's operands and held at 1e-3, and where a code flipped the
      CPU's own step is then held at 1e-2 (`TRAIN_FLIP_LEAF`);
   b. granite-moe-1b at its published widths under its config's fp8_dpa,
      remat full, attn_chunk 512, logits_chunk 512, bf16 compute and f32
      masters: 3 steps of batch 2 x 4096 on `SyntheticLM`, lr 1e-3 with 2
      warmup steps; every loss and grad norm finite and step 3's loss
      below step 1's; median step wall, trained tokens/s, the device
      busy share of one profiled step, peak memory, one `batch()`;
   c. granite at full width cut to 4 layers: two identical backward
      passes compared leaf by leaf, then 6 supervised steps with
      synchronous checkpoints every 3 and a failure injected at step 4,
      whose final params must equal a clean run's bit for bit (save and
      restore seconds printed);
   d. `launch.train.main` in the process (reduced granite, 6 steps,
      async checkpoints every 3), its lines printed.
6. Tensor parallelism (`run_tp`): two gloo ranks share the card
   (`launch.mesh.run_ranks`; NCCL refuses two ranks on one card).
   qwen3-4b under w4a8_kv4_attn8 at phase 3a's geometry, eager, greedy
   on 2 of phase 3's requests cut to 8 new tokens, two requests behind a
   40-token shared prefix with the prefix cache on (a hit with a
   copy-on-write page) and one self-draft round of k 2: the tp=1 engine in this process, then
   each rank at tp 2 on its own seeded copy of the weights (half of
   every page of the pool, the sharded routes, whose body is the paged
   decode kernel after the pool all-gather); every rank's tokens and
   launch counts must equal tp=1's.  Then granite-moe-1b-a400m under
   fp8_dpa, B 1 x S 1024 a rank, 2 steps of `make_compressed_train_step`
   on the f32 route and on the E4M3 wire: losses equal across ranks,
   params the same bits on every rank, the f32 route within 1e-4 of the
   same rows stepped in one process, the E4M3 wire's first loss within
   1e-3 and its params within 5e-3, its residual live.  Pool bytes, wire
   bytes, decode-step walls, gloo's take on CUDA tensors and each rank's
   peak memory are printed.

Prints the engine reports, the prefill and scoring results, the
profiles and the route tables (`roofline:`) as JSON, the phase times, the
kernels' JSON line, the card's
name and power limit, and, as the last line,
{"ok": true, "device": {...}}.
Exits non-zero, printing no result, without a CUDA device or without the
repository's sources.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MATMUL_RTOL, MATMUL_ATOL = 2e-5, 2e-4   # the reference's fused-route pin
FLASH_F32_RTOL = 2e-6             # the f32 flash route's pin (no TF32)
# DPA flash kernel vs plain version: at most this share of the live
# probability codes may differ (a logit summed in another order can cross
# an E4M3 rounding boundary); each output is held to one bf16 ulp plus
# FLASH_F32_RTOL of its row's largest output, plus, in a row with flipped
# codes, what those flips can move it by
DPA_FLASH_MAX_FLIPS = 1e-5
# ... by attention format.  A code flips where its p / ps lies within a
# logit's few-ulp move of a rounding boundary of the grid.  fp16 has 2^7
# times E4M3's boundaries in a binade (10 mantissa bits against 3) and
# keeps a code for p down to 2^-24 of the row's largest, where E4M3 rounds
# every p / ps below 2^-10 to 0: the same logit noise flips two to three
# orders of magnitude more of its codes (on an H100, 5.4e-4 to 1.37e-3 of
# them at hd 64, 128 and 256; PERF.md), each moving its output by a 2^7
# times smaller step, which `_dpa_flash_misses` bounds output by output.
# Its budget is E4M3's times 2^9, 3.7 times the largest share measured, as
# E4M3's is 2.6 times its own (3.9e-6 at hd 256).  E2M1 (1 mantissa bit)
# keeps E4M3's
DPA_FLASH_FLIP_BUDGET = {"fp8_e4m3": DPA_FLASH_MAX_FLIPS,
                         "fp4_e2m1": DPA_FLASH_MAX_FLIPS,
                         "fp16": DPA_FLASH_MAX_FLIPS * 2 ** 9}
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


def median_ms(fn, n: int = 25, warm: int = 3) -> float:
    """Median CUDA-event time of fn over n runs after `warm` warm-ups."""
    import torch
    for _ in range(warm):
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


def device_ms_from(fn, n: int = 20, warm: int = 3):
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
    for _ in range(warm):
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


def device_ms(fn, n: int = 20, warm: int = 3):
    """`device_ms_from`'s time alone."""
    return device_ms_from(fn, n, warm)[0]


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


def bound(work, peak=None, ops_scale=1):
    """(bound ms, "bytes" or "operations") of one launch's census
    (`kernels.census.launch_work`), at `peak` op/s in place of its own
    and its operations times `ops_scale` where given."""
    from repro_torch.kernels import census as CS
    args = (work.bytes, work.ops * ops_scale, peak or work.peak)
    return CS.bound_s(*args) * 1e3, CS.bound_by(*args)


def peak_ops(fmt):
    """The card's peak op/s for operands in fmt (`kernels.census`)."""
    from repro_torch.kernels import census as CS
    return CS.PEAK_OPS[fmt]


TIME_KEYS = ("ms", "plain_ms", "device_ms", "plain_device_ms")


# calls a plain version is timed over each way, after one warm-up: it
# stands beside the kernel and takes milliseconds a call
PLAIN_TIMED = 5


def timings(kernel, plain, plain_n: int = PLAIN_TIMED) -> dict:
    """A kernel's and its plain version's time per call, each both ways:
    `ms` / `plain_ms` the median CUDA-event time of one call (host launch
    time included), `device_ms` / `plain_device_ms` the device time per
    call (`device_ms_from`; `device_from` says where the kernel's came
    from); the plain version over `plain_n` calls each way (one for the
    new formats' many cases)."""
    dev, src = device_ms_from(kernel)
    return {"ms": median_ms(kernel),
            "plain_ms": median_ms(plain, plain_n, 1),
            "device_ms": dev,
            "plain_device_ms": device_ms(plain, plain_n, 1),
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


def _held(what, got, want, extra=0.0):
    """got within the fused route's pin of want (plus `extra`, each
    output's own allowance) and finite, or raise; -> max |got - want|."""
    import torch
    err, ok = _close(got, want, extra)
    if not ok or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: max err {err} over rtol {MATMUL_RTOL}"
                             f" / atol {MATMUL_ATOL}")
    return err


def _block_sum_order(x, wq, sw, kw):
    """What fp16 activations add to the fused route's pin.  A K block's
    partial sum of 128 products stays exact in f32 while every code's
    lowest bit lies within 24 bits of the sum: with E4M3 (3 mantissa
    bits) and E2M1 codes that fails only for codes some 2^14 below the
    block's largest, which random rows almost never hold, so the kernel
    and the plain version agree on each block but for the fold's order.
    With fp16 codes (10 mantissa bits) it fails for any code 2^7 below
    the largest: the two sides round the block's sum in different
    orders, each within PAGED_SUM_SIGMAS sqrt(128) 2^-24 of the block's
    sum of |q w| (the random-walk size of an f32 sum's rounding, as
    paged decode's bound takes it).  -> twice that over the blocks, in
    output units (the plain version on |x| and |w|), or 0 for the other
    formats."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    if kw["fmt_x"] != "fp16":
        return 0.0
    if kw["fmt_w"] == "fp4_e2m1":
        wa = wq & 0x77                       # both nibbles' signs cleared
    else:
        wa = (wq.view(torch.uint8) & 0x7F).view(wq.dtype)
    ref = GM.dpa_grouped_matmul_fused_ref if x.ndim == 3 else \
        DM.dpa_matmul_fused_ref
    mag = ref(x.abs(), wa, sw.abs(), **kw)
    return 2 * PAGED_SUM_SIGMAS * math.sqrt(DM.BK) * 2.0 ** -24 * mag


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
    from repro_torch.kernels import census as CS
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
            t["bound_ms"], b_by = bound(CS.launch_work(
                "dpa_matmul_fused", plan.route, E=1, M=xp.shape[0], K=K,
                N=N, x_bytes=2, fmt_w="fp4_e2m1", pack_w=True))
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


LARGE_M = 4096                    # path D's rows: one 4096-token sequence


def _close(got, want, extra=0.0):
    """-> (max |got - want|, within the fused route's pin plus `extra`)."""
    err = (got - want).abs()
    return float(err.max()), bool(
        (err <= MATMUL_ATOL + MATMUL_RTOL * want.abs() + extra).all())


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
    from repro_torch.kernels import census as CS
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
        work = CS.launch_work("dpa_matmul_fused", "tiled", E=1, M=LARGE_M,
                              K=K, N=N, x_bytes=2, fmt_w="fp4_e2m1",
                              pack_w=True)
        t["bound_ms"], _ = bound(work)
        t["fp16_bound_ms"], _ = bound(work, peak_ops("fp16"))
        t["prepass_ms"], t["prepass_device_ms"] = pre["ms"], pre["device_ms"]
        pre["bound_ms"], _ = bound(CS.launch_work(
            "dpa_act_quant", rows=LARGE_M, K=K, x_bytes=2))
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


def _paged_case(cfg, pol, gen, lengths, page, positions=None,
                q_dtype=None):
    """A paged cache holding `lengths` rows per request (relaid out from a
    contiguous one), queries at `positions` (default: the last row), bf16
    (or `q_dtype`)."""
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
                    device="cuda").to(q_dtype or torch.bfloat16)
    return q, cache, torch.tensor(pos, dtype=torch.int32, device="cuda")


def _paged_work(cfg, fmt, lengths, q, table, wc=None, live=None):
    """The census of one paged decode call (`kernels.census`) over these
    requests' live keys, which only the caller knows: each live K and V
    row's codes (`wc` bytes a row, packed fp4 by default) and scale read
    once, q read and the output written, the block table and positions;
    QK and PV over `live` keys a query row (default: the lengths)."""
    from repro_torch.kernels import census as CS
    return CS.launch_work(
        "paged_decode_attention", fmt=fmt, B=q.shape[0], sq=q.shape[1],
        H=cfg.n_heads, KV=cfg.n_kv_heads, hd=cfg.hd,
        code_bytes=cfg.hd // 2 if wc is None else wc,
        q_bytes=q.element_size(), table_entries=table.numel(),
        kv_rows=sum(lengths), pairs=sum(lengths if live is None else live))


# paged decode vs its plain version, each output's own bound
# (`_paged_case_tol`).  PAGED_P_RTOL: how far apart, relatively, the two
# sides' probabilities can lie.  A logit is an f32 sum of hd products in
# another order, within hd 2^-24 of the sum of their magnitudes (about
# 6e-5 for hd 128 and randn rows), the max moves with it, and the exp adds
# a few f32 ulps: 2^-12 (2.4e-4) holds them with room.
PAGED_P_RTOL = 2.0 ** -12
# the f32 sums of an output (numerator and denominator, n live terms in
# two orders): each within this many sqrt(n) 2^-24 of its terms'
# magnitudes, the random-walk size of a long f32 sum's rounding
PAGED_SUM_SIGMAS = 4.0


def _attn_grid(y, fmt):
    """clip(y, -T, T) onto the attention format's grid, f32 values."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.formats import torch_dtype
    from repro_torch.core.quantize import decode_fp4, encode_fp4
    t = get_format(fmt).quant_target
    y = torch.clamp(y, -t, t)
    if fmt == "fp4_e2m1":
        return decode_fp4(encode_fp4(y))
    return y.to(torch_dtype(fmt)).to(torch.float32)


def _paged_case_tol(args, kw, want):
    """Each output's bound against the plain version `want`, from this
    case's own probabilities (q (B, 1, H, hd)).  The plain arithmetic is
    rebuilt here (it must give `want` bit for bit) and each output may be
    off by: one bf16 ulp of itself; its f32 sums' order, 2
    PAGED_SUM_SIGMAS sqrt(n) 2^-24 of sum_t pg_t |v_t| / den (den the
    row's sum of p codes pg); and the p codes that can flip.  A code can
    flip only where p / psq lies within PAGED_P_RTOL of a rounding
    boundary of the format's grid: there the grid at p / psq (1 -/+
    PAGED_P_RTOL) gives codes lo < hi, and such flips move an output by at
    most sum_t (hi - lo) |v_t - out| / (den - sum_t (hi - lo)).  fp32
    attention has no codes (pg = p), so no flips; an f32 output's ulp is
    f32's.  ->
    (bound shaped like want, {"candidates": codes that can flip,
    "flip_max": the largest flip term})."""
    import torch
    from repro_torch.core.device import batched_rowwise_dot
    from repro_torch.core.kvcache import dequantize_kv, gather_paged_kv
    from repro_torch.core.quantize import quant_rows_grid
    q, kc, ks, vc, vs, table, pos = args
    fmt = kw["fmt"]
    B, sq, H, hd = q.shape
    assert sq == 1, "one query token a request"
    view = gather_paged_kv({"k_codes": kc, "k_scale": ks, "v_codes": vc,
                            "v_scale": vs, "block_table": table})
    k, v = (dequantize_kv(view[f"{n}_codes"], view[f"{n}_scale"],
                          fmt=kw["fmt_kv"], packed=kw["kv_packed"])
            .repeat_interleave(H // kc.shape[2], dim=2).permute(0, 2, 1, 3)
            for n in "kv")                                  # (B, H, S, hd)
    qg, qs = quant_rows_grid(q, fmt)
    lg = batched_rowwise_dot(qg.permute(0, 2, 1, 3), k)     # (B, H, 1, S)
    lg = lg * qs.permute(0, 2, 1, 3) * float(hd ** -0.5)
    live = torch.arange(k.shape[2], device=q.device)[None] <= \
        pos.to(torch.int64)[:, None]
    lg = torch.where(live[:, None, None, :], lg, -1e30)
    p = torch.exp(lg - lg.amax(dim=-1, keepdim=True))
    pg, psq = quant_rows_grid(p, fmt)
    den = pg.sum(dim=-1, keepdim=True)                      # (B, H, 1, 1)
    num = batched_rowwise_dot(pg, v.transpose(-1, -2))      # (B, H, 1, hd)
    out = num * psq / torch.clamp_min(den * psq, 1e-30)
    if not torch.equal(out.permute(0, 2, 1, 3).to(want.dtype), want):
        raise AssertionError("paged case bound: the rebuilt plain version "
                             "differs from paged_decode_attention_ref")
    n = live.sum(dim=-1).to(torch.float32)[:, None, None, None]
    mag = batched_rowwise_dot(pg, v.abs().transpose(-1, -2)) / den
    order = 2 * PAGED_SUM_SIGMAS * n.sqrt() * 2.0 ** -24 * mag
    y = p / psq
    gap = torch.zeros_like(y) if fmt == "fp32" else (
        _attn_grid(y * (1 + PAGED_P_RTOL), fmt)
        - _attn_grid(y * (1 - PAGED_P_RTOL), fmt))          # (B, H, 1, S)
    flip = torch.zeros_like(out)
    b, h, z, t = gap.nonzero(as_tuple=True)
    if b.numel():
        w = gap[b, h, z, t] / (den - gap.sum(-1, keepdim=True))[b, h, z, 0]
        flip.index_put_((b, h, z), w[:, None]
                        * (v[b, h, t] - out[b, h, z]).abs(), accumulate=True)
    ulp = torch.where(want == 0, 0.0, _bf16_ulp(want.float())
                      if want.dtype == torch.bfloat16 else
                      _bf16_ulp(want.float()) * 2.0 ** -16)
    tol = ulp + (order + flip).permute(0, 2, 1, 3)
    return tol, {"candidates": int(b.numel()),
                 "flip_max": float(flip.max())}


def check_paged(cfg, pol, gen, ecfg):
    """The kernel against the gather + dpa_attention plain version.

    The two sum in different orders, so logits differ in the last f32
    bits, exp then differs by ulps, and a probability code can flip to its
    E4M3 neighbour where p / psq sits at a rounding midpoint.  Each output
    is held to the smaller of the format's pin (`PAGED_DECODE_CARD_TOL`,
    2e-2 absolute) and its case's own bound (`_paged_case_tol`: a bf16
    ulp, the sums' order, and what the codes near a boundary can move it
    by, against the row's own denominator), which catches a wrong row,
    page, rank or mask, or p rounded wrongly.  Cases: the engine's
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

    def held(name, got, want, tol):
        err = (got.float() - want.float()).abs()
        if not bool(torch.isfinite(got).all()) or bool((err > tol).any()):
            i = int((err - tol).argmax())
            raise AssertionError(
                f"paged_decode_attention {name}: err {float(err.flatten()[i])}"
                f" > its bound {float(tol.flatten()[i])} (max err "
                f"{float(err.max())})")
        return err

    def compare(name, q, cache, pos):
        args = (q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
                cache["v_scale"], cache["block_table"], pos)
        got = PD.paged_decode_attention(*args, **kw)
        want = PD.paged_decode_attention_ref(*args, **kw)
        torch.cuda.synchronize()
        tol, info = _paged_case_tol(args, kw, want)
        tol = torch.clamp_max(tol, TOL)
        err = held(name, got, want, tol)
        plan = plan_of(q, cache)
        print(f"paged_decode_attention hd={cfg.hd} {name} (split "
              f"{plan.split}, {plan.blocks} blocks): max_abs_err "
              f"{float(err.max()):.3g} (case bound up to "
              f"{float(tol.max()):.3g}, {info['candidates']} codes near a "
              f"boundary), {int((err > 0).sum())} of {err.numel()} outputs "
              "differ")
        return float(err.max()), args, tol

    worst = 0.0
    # the engine's decode geometry: B = max_batch, full block tables
    lengths = [256, 201, 101, 18]
    q, cache, pos = _paged_case(cfg, pol, gen, lengths, ecfg.page_size)
    e, main_args, main_tol = compare("B=4 page=16 lengths [256,201,101,18]",
                                     q, cache, pos)
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
        return bound(_paged_work(cfg, kw["fmt"], lengths, args[0], args[5]))

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
                out.data_ptr(), qm.shape[0], 1, cfg.n_heads,
                cfg.n_kv_heads, cfg.hd, kc.shape[1], table.shape[1], 0, 0,
                cfg.hd ** -0.5, split,
                torch.cuda.current_stream().cuda_stream),
                f"paged_decode split {split}")
        call()
        torch.cuda.synchronize()
        err = held(f"split {split}", out, want, main_tol)
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
    e, long_args, long_tol = compare(
        "B=2 page=16 2048 pages positions [32767,9000]", q, cache, pos)
    worst = max(worst, e)
    lt = timings(lambda: PD.paged_decode_attention(*long_args, **kw),
                 lambda: PD.paged_decode_attention_ref(*long_args, **kw))
    lt["bound_ms"], lt["bound_by"] = bound_of(long_lengths, long_args)
    lt["split"] = plan_of(q, cache).split
    print(f"paged_decode_attention hd={cfg.hd} long context: "
          f"{fmt_times(lt)} bound_ms {lt['bound_ms']:.6f} "
          f"({lt['bound_by']})")
    t["long"] = {k: lt[k] for k in TIME_KEYS + ("bound_ms", "split")}
    t["long"].update(max_abs_err=e, case_tol_max=float(long_tol.max()))
    t["case_tol_max"] = float(main_tol.max())
    del q, cache, pos, long_args, long_tol
    return worst, t


# the kernel's attention formats beyond the serving policy's E4M3, and the
# KV formats it serves: (fmt_kv, kv_packed)
PAGED_NEW_ATTN = ("fp4_e2m1", "fp16")
PAGED_KV = (("fp4_e2m1", True), ("fp8_e4m3", False))
# the pairs f32 attention and 2-byte and unpacked KV codes brought (the
# presets kv8_attn_f32, kv16_attn_f32 and attn_fp16_dpa among them), each
# at the engine's shape and the long context, timed; then the remaining
# KV codes (bf16, E5M2) under E4M3 attention at the engine's shape.
# fp32 attention runs f32 q: its bound (1e-5) is below a bf16 ulp
PAGED_SLICE_PAIRS = (("fp32", ("fp8_e4m3", False)), ("fp32", ("fp16", False)),
                     ("fp32", ("fp4_e2m1", True)),
                     ("fp32", ("fp4_e2m1", False)),
                     ("fp16", ("fp16", False)))
PAGED_SLICE_EXTRA = (("fp8_e4m3", ("bf16", False)),
                     ("fp8_e4m3", ("fp8_e5m2", False)))
# the draft length of the verify fold's check and of phase 3j.  At the
# engine's max_batch 4 the verify pass is 4 (k + 1) = 20 rows, below the
# fused kernel's TILED_MIN_M = 128: there the split-K route's row bits do
# not depend on M, so verify rows carry the decode steps' bits (the
# Engine refuses 128 rows or more on the card, `check_verify_rows`)
VERIFY_K = 4


def check_paged_formats(cfg, gen, ecfg):
    """The kernel's fp4 (E2M1) and fp16 attention formats over packed-fp4
    and E4M3 KV, and E4M3 attention over E4M3 KV, against the plain
    version at the engine's shape (B 4, lengths 256/201/101/18) and, for
    the new formats, at the long context (B 2, 2,048 pages of 16), each
    output held to the smaller of its format's bound
    (`PAGED_DECODE_CARD_TOLS`, derived in kernels/registry.py for the
    least denominator) and its case's own (`_paged_case_tol`, from the
    case's codes; at the long context far below the format's, since an
    output there averages thousands of keys).  Timed: every case's kernel
    device ms; the
    engine shape over packed fp4 (the serving cache) both ways with its
    plain version's, beside each bound.  -> {fmt: {...}}."""
    import torch
    from repro_torch.core.policy import TransPrecisionPolicy
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels.registry import PAGED_DECODE_CARD_TOLS as TOLS
    out = {}
    cases = [(f, kv) for f in PAGED_NEW_ATTN for kv in PAGED_KV]
    cases.append(("fp8_e4m3", ("fp8_e4m3", False)))
    cases += PAGED_SLICE_PAIRS + PAGED_SLICE_EXTRA
    lengths, long_lengths = [256, 201, 101, 18], [32768, 9001]
    for fmt, (fmt_kv, packed) in cases:
        pol = TransPrecisionPolicy(fmt_attn=fmt, fmt_kv=fmt_kv,
                                   kv_packed=packed)
        kw = dict(fmt=fmt, fmt_kv=fmt_kv, kv_packed=packed)
        tol = TOLS[fmt]
        res = out.setdefault(fmt, {"tol": tol, "kv": {}})
        for name, lens, page, pos in (
                ("engine", lengths, ecfg.page_size, None),
                ("long", long_lengths, 16, [32767, 9000])):
            if name == "long" and fmt == "fp8_e4m3":
                continue
            q, cache, p = _paged_case(
                cfg, pol, gen, lens, page, pos,
                torch.float32 if fmt == "fp32" else None)
            args = (q, cache["k_codes"], cache["k_scale"], cache["v_codes"],
                    cache["v_scale"], cache["block_table"], p)
            got = PD.paged_decode_attention(*args, **kw)
            want = PD.paged_decode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            case_tol, info = _paged_case_tol(args, kw, want)
            case_tol = torch.clamp_max(case_tol, tol)
            errs = (got.float() - want.float()).abs()
            err = float(errs.max())
            if not bool(torch.isfinite(got).all()) or bool(
                    (errs > case_tol).any()):
                i = int((errs - case_tol).argmax())
                raise AssertionError(
                    f"paged_decode_attention {fmt} attention over "
                    f"{fmt_kv}{' packed' if packed else ''} KV, {name}: "
                    f"err {float(errs.flatten()[i])} > its bound "
                    f"{float(case_tol.flatten()[i])} (max err {err})")
            b_ms, b_by = bound(_paged_work(
                cfg, fmt, lens, q, args[5],
                cache["k_codes"].shape[3] * cache["k_codes"].element_size()))
            kern = lambda: PD.paged_decode_attention(*args, **kw)  # noqa
            if name == "engine" and (packed or (fmt, (fmt_kv, packed)) in
                                     PAGED_SLICE_PAIRS):
                t = timings(kern, lambda: PD.paged_decode_attention_ref(
                    *args, **kw))
            else:
                t = {"device_ms": device_ms(kern)}
            t.update(max_abs_err=err, case_tol_max=float(case_tol.max()),
                     candidates=info["candidates"], bound_ms=b_ms,
                     bound_by=b_by)
            key = f"{fmt_kv}{'_packed' if packed else ''}"
            res["kv"].setdefault(key, {})[name] = t
            print(f"paged_decode_attention hd={cfg.hd} {fmt} attention, "
                  f"{key} KV, {name}: max_abs_err {err:.3g} (case bound up "
                  f"to {t['case_tol_max']:.3g}, {info['candidates']} codes "
                  f"near a boundary; format bound {tol:.4g}), kernel device "
                  f"ms {t['device_ms']}, bound_ms "
                  f"{b_ms:.6f} ({b_by})"
                  + (f"; {fmt_times(t)}" if "ms" in t else ""))
            del q, cache, p, args, got, want, case_tol, errs
    return out


def check_verify_fold(cfg, gen, ecfg, k=VERIFY_K):
    """The speculative verify fold: one launch over B (k+1) query rows
    (row (b, i) at position positions[b] + i, the decode plan's split at
    B) against k+1 single-position launches, `torch.equal` row for row,
    for each attention format over the engine's packed-fp4 cache at the
    engine's shape; the fold's device ms beside the k+1 launches' and its
    bound.  -> {fmt: {...}}."""
    import torch
    from repro_torch.core.policy import TransPrecisionPolicy
    from repro_torch.kernels import paged_decode as PD
    out = {}
    lengths = [256, 201, 101, 18]
    B, KV, G = len(lengths), cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    pairs = [(f, ("fp4_e2m1", True)) for f in ("fp8_e4m3",) + PAGED_NEW_ATTN]
    for fmt, (fmt_kv, packed) in pairs + [("fp32", ("fp8_e4m3", False)),
                                          ("fp16", ("fp16", False))]:
        pol = TransPrecisionPolicy(fmt_attn=fmt, fmt_kv=fmt_kv,
                                   kv_packed=packed)
        kw = dict(fmt=fmt, fmt_kv=fmt_kv, kv_packed=packed)
        pos0 = [n - 1 - k for n in lengths]
        _, cache, pos = _paged_case(cfg, pol, gen, lengths, ecfg.page_size,
                                    pos0)
        q = torch.randn((B, k + 1, cfg.n_heads, cfg.hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        rest = (cache["k_codes"], cache["k_scale"], cache["v_codes"],
                cache["v_scale"], cache["block_table"])
        singles = [q[:, i:i + 1].contiguous() for i in range(k + 1)]
        shifted = [pos + i for i in range(k + 1)]

        def fold():
            return PD.paged_decode_attention(q, *rest, pos, **kw)

        def stepped():
            return [PD.paged_decode_attention(singles[i], *rest, shifted[i],
                                              **kw) for i in range(k + 1)]

        got, want = fold(), stepped()
        torch.cuda.synchronize()
        for i in range(k + 1):
            if not torch.equal(got[:, i:i + 1], want[i]):
                raise AssertionError(
                    f"verify fold {fmt} over {fmt_kv}: row {i} differs "
                    "from the single-position launch")
        wc = cache["k_codes"].shape[3] * cache["k_codes"].element_size()
        plan = PD.fold_plan(B, k + 1, KV, G, cfg.hd, wc, ecfg.page_size,
                            cache["block_table"].shape[1])
        split = PD.paged_plan(B, KV, G, cfg.hd, wc, ecfg.page_size,
                              cache["block_table"].shape[1]).split
        if plan.split != split:
            raise AssertionError(f"fold split {plan.split} != decode {split}")
        # each live row read once for all k+1 tokens; row i of a request
        # scores n - k + i keys
        live = [n - k + i for n in lengths for i in range(k + 1)]
        b_ms, b_by = bound(_paged_work(cfg, fmt, lengths, q,
                                       cache["block_table"], wc, live=live))
        t = timings(fold, lambda: PD.paged_decode_attention_ref(
            q, *rest, pos, **kw))
        t.update(bound_ms=b_ms, bound_by=b_by, split=plan.split,
                 blocks=plan.blocks, rows=B * (k + 1),
                 stepped_device_ms=device_ms(stepped))
        out[fmt if packed else f"{fmt} over {fmt_kv}"] = t
        print(f"verify fold hd={cfg.hd} {fmt} attention over {fmt_kv}"
              f"{' packed' if packed else ''}, B={B} k={k}: "
              f"{B * (k + 1)} rows in one launch (split {plan.split}, "
              f"{plan.blocks} blocks) equal to {k + 1} single-position "
              f"launches bit for bit; fold {fmt_times(t)}; the {k + 1} "
              f"launches device {t['stepped_device_ms']} ms; bound_ms "
              f"{b_ms:.6f} ({b_by})")
        del q, cache, pos, got, want
    return out


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
    from repro_torch.kernels import census as CS
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
            t["bound_ms"], b_by = bound(CS.launch_work(
                "dpa_grouped_matmul_fused", plan.route, E=E, M=M, K=K, N=N,
                x_bytes=2, fmt_w="fp4_e2m1", pack_w=True))
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


def _fp8_operands(xq, wq, kw):
    """The codes widened onto fp8 (exact: every E2M1 value is an e4m3
    value; E4M3 and E5M2 codes stay themselves), rows padded to 16 for the
    library's alignment, the weights column-major: the library's inputs
    for the same product."""
    import torch
    from repro_torch.kernels.dpa_matmul import widen

    def fp8(fmt):
        return torch.float8_e5m2 if fmt == "fp8_e5m2" else \
            torch.float8_e4m3fn
    x8 = widen(xq, kw["fmt_x"], packed=kw["pack_x"], dim=-1)
    x8 = torch.nn.functional.pad(x8, (0, 0, 0, -x8.shape[-2] % 16))
    w8 = widen(wq, kw["fmt_w"], packed=kw["pack_w"], dim=-2)
    w8 = w8.transpose(-1, -2).contiguous().transpose(-1, -2)
    return (x8.to(fp8(kw["fmt_x"])).contiguous(), w8.to(fp8(kw["fmt_w"])))


def _library_call(xq, wq, sx, sw, kw=None):
    """One PyTorch call computing the prequant product on the same codes
    and scales, as a function of no arguments, with its name and the
    function that takes its output to the kernel's (None where the call
    is the kernel's function), or (None, why, None) where there is none:
    `torch._scaled_mm` (`torch._scaled_grouped_mm` for an expert stack;
    bf16 out, the only output rowwise scaling takes) on fp8 codes, and for
    fp16 and bf16 codes `torch.matmul` (out in the codes' dtype; the
    scales are not part of the call)."""
    import torch
    kw = kw or FP4_PACKED
    grouped = xq.ndim == 3
    if kw["fmt_x"] in ("fp16", "bf16"):
        return ((lambda: torch.matmul(xq, wq)), "matmul",
                lambda out: (out.float() * sx) * sw)
    fn_name = "_scaled_grouped_mm" if grouped else "_scaled_mm"
    if not hasattr(torch, fn_name):
        return None, f"none: torch {torch.__version__} has no {fn_name}", None
    x8, w8 = _fp8_operands(xq, wq, kw)
    sa = torch.nn.functional.pad(sx.reshape(*sx.shape[:-2], -1),
                                 (0, x8.shape[-2] - xq.shape[-2]))
    if grouped:
        sb = sw.reshape(sw.shape[0], -1).contiguous()
        return (lambda: torch._scaled_grouped_mm(
            x8, w8, sa.contiguous(), sb, out_dtype=torch.bfloat16)), \
            fn_name, None
    return (lambda: torch._scaled_mm(
        x8, w8, scale_a=sa.reshape(-1, 1).contiguous(),
        scale_b=sw.contiguous(), out_dtype=torch.bfloat16)), fn_name, None


def library_prequant(xq, wq, sx, sw, want, kw=None):
    """The library call of `_library_call`: -> (ms, device ms, max_abs_err
    vs the plain version, note), timed as `timings` times a kernel."""
    call, fn_name, post = _library_call(xq, wq, sx, sw, kw)
    if call is None:
        return None, None, None, fn_name
    try:
        out = call()
    except (RuntimeError, TypeError, ValueError) as e:   # a yardstick only
        return (None, None, None,
                f"none: torch.{fn_name} refused ({str(e)[:120]})")
    note = f"torch.{fn_name}, {str(out.dtype).split('.')[-1]} out"
    if post is not None:
        out = post(out)
        note += ", scales outside the call"
    err = float((out[..., :want.shape[-2], :].float() - want).abs().max())
    return (median_ms(call), device_ms(call), err,
            f"{note} (outputs up to {float(want.abs().max()):.4g})")


# the prequant kernels' operands: packed E2M1 on both sides
FP4_PACKED = dict(fmt_x="fp4_e2m1", fmt_w="fp4_e2m1", pack_x=True,
                  pack_w=True)
# tile edges of the prequant kernel's launch plan, checked untimed
PREQUANT_EDGE_ROWS = (1, 16, 17, 64)
# packed bytes whose two codes are both +-6 (E2M1 codes 0x7 and 0xF)
SIX_BYTES = (0x77, 0x7F, 0xF7, 0xFF)
# path B walks this many layers' weights between two calls of one matrix
# layers' weights a cold layer rotates over: 24 x 50 MB of qwen3-4b
# codes are 24 times the 50 MB L2
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
    from repro_torch.kernels import census as CS
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
                t["bound_ms"], b_by = bound(CS.launch_work(
                    kern.__name__, E=n_e, M=M, K=K, N=N, **kw))
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
        per_layer["cold"] = cold_prequant_layer(
            kern, shapes, lambda rows, K, N: (
                (codes(*lead, K // 2, N), scales(*lead, 1, N))
                if rows is None else
                (codes(*lead, rows, K // 2), scales(*lead, rows, 1))))
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


def cold_prequant_layer(kern, shapes, operand, kw=FP4_PACKED, M=8,
                        layers=COLD_LAYERS):
    """One decode layer of a prequant wrapper and of its library call,
    rotating over `layers` layers' distinct weight codes, as path B walks
    them (`cold_layer`).  `operand(rows, K, N)` makes the activations'
    (rows = M) or the weights' (rows = None) codes and scales."""
    kcalls, lcalls = [], []
    xs = {name: operand(M, K, N) for name, (K, N) in shapes.items()}
    for _ in range(layers):
        for name, (K, N) in shapes.items():
            x, sx = xs[name]
            wq, sw = operand(None, K, N)
            args = (x, wq, sx, sw)
            kcalls.append(lambda a=args: kern(*a, **kw))
            lcalls.append(_library_call(*args, kw)[0])
    return cold_layer(f"{kern.__name__} {_kw_name(kw)}", M, layers, kcalls,
                      lcalls)


def _kw_name(kw) -> str:
    """'fp8_e4m3 x fp4_e2m1 packed' for a prequant call's formats."""
    return " x ".join(f"{kw['fmt_' + s]}{' packed' if kw['pack_' + s] else ''}"
                      for s in "xw")


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


# -----------------------------------------------------------------------------
# phase 2: the TransDot datapath — the golden model, the oracle, and the
# prequant kernels in every operand format
# -----------------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "golden" / "dpa_vectors.npz"
GOLDEN_MODES = (("fp16", "fp32", 2), ("fp8_e4m3", "fp32", 4),
                ("fp4_e2m1", "fp32", 8), ("fp32", "fp32", 1),
                ("fp16", "fp16", 2), ("fp8_e4m3", "fp16", 4))
RANDOM_MODES = GOLDEN_MODES + (("fp8_e5m2", "fp32", 4), ("bf16", "fp32", 2))
NARROW_WINDOW = 24          # window_bits of the narrow-window batches
RANDOM_LANES = 4096         # lanes of each random batch, card and CPU
# benchmarks/paper_tables.py table1_modes: (mode, fmt_ab, fmt_acc, N)
TABLE1_MODES = (("fp32_fma_scalar", "fp32", "fp32", 1),
                ("fp16_fma_scalar", "fp16", "fp16", 1),
                ("fp16_fma_simd", "fp16", "fp16", 1),
                ("fp16_dpa_fp32", "fp16", "fp32", 2),
                ("fp8_fma_scalar", "fp8_e4m3", "fp8_e4m3", 1),
                ("fp8_fma_simd", "fp8_e4m3", "fp8_e4m3", 1),
                ("fp8_dpa_fp32", "fp8_e4m3", "fp32", 4),
                ("fp4_dpa_fp32", "fp4_e2m1", "fp32", 8))
TABLE1_LANES = (4096, 1 << 20)   # the reference's call, and a card-sized one
# benchmarks/paper_tables.py numerics_dpa_vs_sequential
NUMERICS_MODES = (("fp16", 2, "fp16"), ("fp8_e4m3", 4, "fp16"),
                  ("fp8_e4m3", 4, "fp32"), ("fp4_e2m1", 8, "fp32"))
NUMERICS_TRIALS = 2000


def _mode_codes(rng, fa, fc, n, lanes):
    """Codes over the whole code space (specials included) in half the
    lanes, finite codes of unit-normal data in the other half."""
    import numpy as np
    from repro_torch.core import formats as F
    fa, fc = F.get_format(fa), F.get_format(fc)
    a = rng.integers(0, 1 << fa.bits, (lanes, n), dtype=np.uint64)
    b = rng.integers(0, 1 << fa.bits, (lanes, n), dtype=np.uint64)
    c = rng.integers(0, 1 << fc.bits, lanes, dtype=np.uint64)
    h = lanes // 2
    a[h:] = F.float_to_codes(rng.normal(size=(lanes - h, n)), fa)
    b[h:] = F.float_to_codes(rng.normal(size=(lanes - h, n)), fa)
    c[h:] = F.float_to_codes(rng.normal(size=lanes - h) * 4, fc)
    return tuple(_i64(x) for x in (a, b, c))


def _i64(a):
    """numpy codes -> an int64 CPU tensor."""
    import numpy as np
    import torch
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def check_datapath():
    """The golden model (`core.dpa.dpa_codes`) and the FPnew baseline
    (`core.fpnew_ref.sequential_fma_codes`) on CUDA tensors: every batch
    of `tests/golden/dpa_vectors.npz` (read with numpy) replayed bit for
    bit; seeded random batches in each golden mode and with E5M2 and bf16
    operands (specials included), at the default window and at
    `NARROW_WINDOW`, equal to the CPU's codes; the card's lanes/s in each
    of Table I's modes; and the paper's numerics table (DPA's and
    sequential FMA's mean |error| against the exact sum), computed on the
    card and equal to the CPU's."""
    import numpy as np
    import torch
    from repro_torch.core import dpa, formats as F, fpnew_ref
    res = {"golden_lanes": 0, "random_lanes": 0}
    with np.load(GOLDEN) as v:
        arrays = {k: v[k] for k in v.files}
    for fa, fc, n in GOLDEN_MODES:
        for kind in ("finite", "specials"):
            tag = f"{fa}_x{n}_{fc}_{kind}"
            a, b, c = (_i64(arrays[f"{tag}__{k}"]).cuda() for k in "abc")
            got = dpa.dpa_codes(a, b, c, fa, fc).cpu()
            bad = int((got != _i64(arrays[f"{tag}__out"])).sum())
            if bad:
                raise AssertionError(f"golden {tag}: {bad} of {got.numel()} "
                                     "lanes differ on the card")
            res["golden_lanes"] += got.numel()
    print(f"datapath: the golden file's {2 * len(GOLDEN_MODES)} batches "
          f"({res['golden_lanes']} lanes) replayed on the card bit for bit")

    rng = np.random.default_rng(23)
    for fa, fc, n in RANDOM_MODES:
        a, b, c = _mode_codes(rng, fa, fc, n, RANDOM_LANES)
        runs = [(f"dpa W={w or 'default'}",
                 lambda t, w=w: dpa.dpa_codes(*t, fa, fc, window_bits=w))
                for w in (None, NARROW_WINDOW)]
        runs.append(("sequential_fma",
                     lambda t: fpnew_ref.sequential_fma_codes(*t, fa, fc)))
        for what, fn in runs:
            cpu = fn((a, b, c))
            card = fn((a.cuda(), b.cuda(), c.cuda())).cpu()
            if not torch.equal(cpu, card):
                raise AssertionError(
                    f"{what} {fa}x{n}->{fc}: {int((cpu != card).sum())} of "
                    f"{cpu.numel()} lanes differ between the card and the "
                    "CPU")
            res["random_lanes"] += cpu.numel()
    print(f"datapath: {len(RANDOM_MODES)} modes' random batches (specials "
          f"included; dpa at the default window and W={NARROW_WINDOW}, and "
          f"sequential FMA), {res['random_lanes']} lanes: the card's codes "
          "equal the CPU's")

    rng = np.random.default_rng(0)
    table1 = {}
    for mode, fa, fc, n in TABLE1_MODES:
        row = {"n_terms": n, "fmt_acc": fc}
        for lanes in TABLE1_LANES:
            a = _i64(F.float_to_codes(rng.normal(size=(lanes, n)),
                                           F.get_format(fa))).cuda()
            b = _i64(F.float_to_codes(rng.normal(size=(lanes, n)),
                                           F.get_format(fa))).cuda()
            c = _i64(F.float_to_codes(rng.normal(size=(lanes,)),
                                           F.get_format(fc))).cuda()
            ms = median_ms(lambda: dpa.dpa_codes(a, b, c, fa, fc), n=5)
            row[f"ms_{lanes}"] = ms
            row[f"lanes_per_s_{lanes}"] = lanes / ms * 1e3
        table1[mode] = row
        print(f"datapath table1/{mode} ({fa} x{n} -> {fc}): "
              + ", ".join(f"{lanes} lanes {row[f'ms_{lanes}']:.3f} ms "
                          f"({row[f'lanes_per_s_{lanes}']:.4g} lanes/s)"
                          for lanes in TABLE1_LANES))
    res["table1"] = table1

    rng = np.random.default_rng(1)        # paper_tables' seed and order
    numerics = {}
    for fmt, n, acc in NUMERICS_MODES:
        fa, fc = F.get_format(fmt), F.get_format(acc)
        a = rng.normal(size=(NUMERICS_TRIALS, n))
        b = rng.normal(size=(NUMERICS_TRIALS, n))
        ac, bc = F.float_to_codes(a, fa), F.float_to_codes(b, fa)
        cc = np.zeros(NUMERICS_TRIALS, np.uint32)
        exact = (F.codes_to_np(ac, fa).astype(np.float64)
                 * F.codes_to_np(bc, fa).astype(np.float64)).sum(1)
        t = tuple(_i64(x) for x in (ac, bc, cc))
        errs = {}
        for what, fn in (("dpa", dpa.dpa_codes),
                         ("seq", fpnew_ref.sequential_fma_codes)):
            card = fn(*(x.cuda() for x in t), fa, fc).cpu()
            if not torch.equal(card, fn(*t, fa, fc)):
                raise AssertionError(f"numerics {fmt}x{n}->{acc} {what}: "
                                     "the card's codes differ from the CPU's")
            got = F.codes_to_np(card, fc).astype(np.float64)
            errs[what] = float(np.abs(got - exact).mean())
        key = f"{fmt}x{n}_to_{acc}"
        numerics[key] = {"dpa_err": errs["dpa"], "seq_err": errs["seq"],
                         "improvement": errs["seq"] / max(errs["dpa"],
                                                          1e-300)}
        print(f"datapath numerics/{key}: dpa_err={errs['dpa']:.2e};"
              f"seq_err={errs['seq']:.2e};improvement="
              f"{numerics[key]['improvement']:.2f}x (card = CPU)")
    res["numerics"] = numerics
    return res


# tests/test_grouped_dpa.py ORACLE_MODES: (fmt, K, raw exponent window)
ORACLE_MODES = (("fp16", 4, (15, 15)), ("fp8_e4m3", 8, (6, 9)),
                ("fp4_e2m1", 8, None))
ORACLE_EXPERTS = (1, 2, 32)     # dense, and grouped at granite's 32


def _windowed_codes(rng, fmt, shape, ewin):
    """tests/test_grouped_dpa.py _windowed_codes: random sign and mantissa,
    the raw exponent field confined to `ewin` (None: E2M1's full grid)."""
    import numpy as np
    from repro_torch.core import formats as F
    f = F.get_format(fmt)
    lo, hi = ewin if ewin is not None else (0, f.exp_mask)
    e = rng.integers(lo, hi + 1, size=shape)
    man = rng.integers(0, f.man_mask + 1, size=shape)
    sign = rng.integers(0, 2, size=shape) << (f.bits - 1)
    return (sign | (e << f.man_bits) | man).astype(np.int64)


def _oracle_sums(fmt, xc, wc):
    """`oracle.dpa_exact` of every output of codes xc (E, M, K) times wc
    (E, K, N), c = +0, into f32: (E, M, N) uint32 codes."""
    import numpy as np
    from repro_torch.core import formats as F, oracle
    E, M, K = xc.shape
    N = wc.shape[-1]
    a = np.broadcast_to(xc[:, :, None, :], (E, M, N, K)).reshape(-1, K)
    b = np.broadcast_to(wc.transpose(0, 2, 1)[:, None], (E, M, N, K)
                        ).reshape(-1, K)
    return oracle.dpa_exact(a, b, np.zeros(E * M * N, np.uint32),
                            F.get_format(fmt), F.FP32).reshape(E, M, N)


def _prequant_vs_oracle(fmt, xc, wc, pack, want):
    """The prequant wrapper (dense at E = 1) on codes xc (E, M, K) and wc
    (E, K, N), K padded with zero codes to a multiple of 128, unit scales,
    against the oracle's codes `want`: -> (mismatching outputs, outputs)."""
    import numpy as np
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core.packing import pack_fp4_axis
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    E, M, K = xc.shape
    N = wc.shape[-1]
    Kp = -(-K // DM.BK) * DM.BK
    xp = np.zeros((E, M, Kp), np.int64)
    wp = np.zeros((E, Kp, N), np.int64)
    xp[..., :K], wp[:, :K] = xc, wc
    xt = F.codes_to_tensor(torch.from_numpy(xp).cuda(), fmt)
    wt = F.codes_to_tensor(torch.from_numpy(wp).cuda(), fmt)
    if pack:
        xt, wt = pack_fp4_axis(xt, -1), pack_fp4_axis(wt, -2)
    kw = dict(fmt_x=fmt, fmt_w=fmt, pack_x=pack, pack_w=pack)
    sx = torch.ones(E, M, 1, device="cuda")
    sw = torch.ones(E, 1, N, device="cuda")
    if E == 1:
        got = DM.dpa_matmul_prequant(xt[0], wt[0], sx[0], sw[0], **kw)[None]
    else:
        got = GM.dpa_grouped_matmul_prequant(xt, wt, sx, sw, **kw)
    got = got.cpu().numpy().view(np.uint32)
    return int((got != want).sum()), got.size


def check_prequant_oracle():
    """The prequant kernels, dense (E = 1) and grouped (E = 2, 32), against
    the exact oracle bit for bit in the paper's three DPA modes, on the
    reference test's windowed codes (tests/test_grouped_dpa.py: the
    exponents confined so that every exact sum is an f32 value): fp16,
    raw exponent 15, K = 4; E4M3, raw exponents 6-9, K = 8; E2M1 over the
    full grid, K = 8 (packed and one code a byte); and E2M1 at qwen3-4b's
    K = 2560, where every partial sum is exact too."""
    import numpy as np
    rng = np.random.default_rng(17)
    M, N = 8, 16
    res, lanes = {}, 0
    cases = [(fmt, K, ewin, E) for fmt, K, ewin in ORACLE_MODES
             for E in ORACLE_EXPERTS] + [("fp4_e2m1", 2560, None, 1)]
    for fmt, K, ewin, E in cases:
        xc = _windowed_codes(rng, fmt, (E, M, K), ewin)
        wc = _windowed_codes(rng, fmt, (E, K, N), ewin)
        want = _oracle_sums(fmt, xc, wc)
        for pack in ((False, True) if fmt == "fp4_e2m1" else (False,)):
            bad, n = _prequant_vs_oracle(fmt, xc, wc, pack, want)
            key = f"{fmt}{' packed' if pack else ''} K={K} E={E}"
            if bad:
                raise AssertionError(f"prequant vs oracle, {key}: {bad} of "
                                     f"{n} outputs differ from the exact sum")
            res[key] = n
            lanes += n
    print(f"datapath: prequant kernels vs oracle.dpa_exact, {len(res)} cases"
          f" ({lanes} outputs; fp16 x2, E4M3 x4 and E2M1 x8 modes, dense and "
          "grouped, and E2M1 at K=2560): every output bit for bit")
    return res


# the prequant kernels' new operand formats, each on both sides (the
# timed cases), and mixes (checked): (fmt_x, pack_x, fmt_w, pack_w)
PREQUANT_FORMATS = ("fp16", "bf16", "fp8_e4m3", "fp8_e5m2", "fp4_e2m1")
PREQUANT_MIXES = (("fp8_e4m3", False, "fp4_e2m1", True),
                  ("bf16", False, "fp8_e4m3", False),
                  ("fp16", False, "fp8_e5m2", False),
                  ("fp4_e2m1", False, "fp4_e2m1", True))


# the larger row tiles (32 and 64 rows a block; 100: two tiles, the last
# partial), checked untimed in every format
PREQUANT_FORMAT_EDGE_ROWS = (32, 64, 100)


def _format_operand(v, fmt, pack, dim):
    """f32 data -> (codes in fmt's container, f32 scales with `dim` kept):
    the port's absmax quantizer, E2M1 packed along `dim` if asked."""
    from repro_torch.core import formats as F, quantize as Q
    from repro_torch.core.packing import pack_fp4_axis
    grid, scale = Q.quant_rows_grid(v, fmt, dim=dim)
    if fmt == "fp4_e2m1":
        codes = Q.encode_fp4(grid)
        return (pack_fp4_axis(codes, dim) if pack else codes), scale
    return grid.to(F.torch_dtype(fmt)).contiguous(), scale


def check_prequant_formats(cfg, gen):
    """The prequant kernels in each new operand format (fp16, bf16, E4M3,
    E5M2, E2M1 one code a byte; both sides) and in four mixes, dense at
    granite's attention projections and grouped at its experts, M = 8 and
    11 and the larger row tiles' `PREQUANT_FORMAT_EDGE_ROWS`, on
    absmax-quantized unit-normal data (positive scales): within rtol 2e-5
    / atol 2e-4 of the plain version (the reference test's pin), bit for
    bit where both sides are E2M1 (exact sums).  Each format's decode
    layer (M = 8) is timed warm (one call repeated: the weights sit in
    L2) and cold (rotating over `COLD_LAYERS` layers' weights), with its
    bound and its library call."""
    import torch
    from repro_torch.kernels import census as CS
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    E = cfg.n_experts
    out = {}
    cases = [(f, False, f, False) for f in PREQUANT_FORMATS] + \
        list(PREQUANT_MIXES)
    for what, shapes, lead in (("dense", _attn_shapes(cfg), ()),
                               ("grouped", _expert_shapes(cfg), (E,))):
        kern = GM.dpa_grouped_matmul_prequant if lead else \
            DM.dpa_matmul_prequant
        ref = GM.dpa_grouped_matmul_prequant_ref if lead else \
            DM.dpa_matmul_prequant_ref
        n_e = E if lead else 1
        res = {}
        for fx, px, fw, pw in cases:
            kw = dict(fmt_x=fx, fmt_w=fw, pack_x=px, pack_w=pw)
            name = _kw_name(kw)
            exact = fx == fw == "fp4_e2m1"
            timed_case = (fx, px) == (fw, pw)
            worst, timed, lib = 0.0, {}, {}
            for K, N in sorted(set(shapes.values())):
                wq, sw = _format_operand(
                    torch.randn(*lead, K, N, generator=gen, device="cuda"),
                    fw, pw, -2)
                for M in (8, 11) + PREQUANT_FORMAT_EDGE_ROWS:
                    x = torch.randn(*lead, M, K, generator=gen,
                                    device="cuda")
                    if lead:
                        x = _drop(x, [max(1, M // 2)] * (E - 1) + [0])
                    xq, sx = _format_operand(x, fx, px, -1)
                    args = (xq, wq, sx, sw)
                    got = kern(*args, **kw)
                    want = ref(*args, **kw)
                    torch.cuda.synchronize()
                    err = (got - want).abs()
                    held = torch.equal(got, want) if exact else bool(
                        (err <= MATMUL_ATOL + MATMUL_RTOL * want.abs()).all())
                    if not held or not bool(torch.isfinite(got).all()):
                        raise AssertionError(
                            f"{kern.__name__} {name} K={K} N={N} M={M}: max "
                            f"err {float(err.max())} outside "
                            + ("0" if exact else f"rtol {MATMUL_RTOL} / atol "
                               f"{MATMUL_ATOL}"))
                    worst = max(worst, float(err.max()))
                    if M != 8 or not timed_case:
                        continue
                    t = timings(lambda: kern(*args, **kw),
                                lambda: ref(*args, **kw))
                    t["bound_ms"], t["bound_by"] = bound(CS.launch_work(
                        kern.__name__, E=n_e, M=M, K=K, N=N, **kw))
                    timed[(K, N, M)] = t
                    lib[(K, N, M)] = library_prequant(*args, want, kw)
            res[name] = {"max_abs_err": worst,
                         "held": "bit for bit" if exact else
                         f"rtol {MATMUL_RTOL} / atol {MATMUL_ATOL}"}
            if timed_case:
                layer = _per_layer(timed, shapes, 8)
                layer["bound_by"] = timed[next(iter(timed))]["bound_by"]
                libs = [lib[(K, N, 8)] for K, N in shapes.values()]
                for i, key in enumerate(("library_ms", "library_device_ms")):
                    vals = [v[i] for v in libs]
                    layer[key] = None if None in vals else sum(vals)
                layer["library"] = libs[0][3]
                res[name].update(layer)
                print(f"{kern.__name__} {name}, one decode layer (M=8, "
                      f"{len(shapes)} calls), warm: {fmt_times(layer)}, "
                      f"bound {layer['bound_ms']:.5f} ms "
                      f"({layer['bound_by']}), library {layer['library']}: "
                      f"{layer['library_ms']} ms (device "
                      f"{layer['library_device_ms']}); max_abs_err {worst:.3g}")

                def operand(rows, K, N, fx=fx, fw=fw):
                    if rows is None:
                        return _format_operand(torch.randn(
                            *lead, K, N, generator=gen, device="cuda"),
                            fw, False, -2)
                    return _format_operand(torch.randn(
                        *lead, rows, K, generator=gen, device="cuda"),
                        fx, False, -1)
                res[name]["cold"] = cold_prequant_layer(kern, shapes,
                                                        operand, kw)
                gc.collect()
                torch.cuda.empty_cache()
            rows = ", ".join(map(str, (8, 11) + PREQUANT_FORMAT_EDGE_ROWS))
            print(f"{kern.__name__} {name}: M {rows} held "
                  f"({res[name]['held']}), max_abs_err {worst:.3g}")
        out[what] = res
    return out


def _attn_inputs(gen, H, KV, S, hd, dtype):
    import torch
    q = torch.randn((1, H, S, hd), generator=gen, device="cuda")
    k = torch.randn((1, KV, S, hd), generator=gen, device="cuda")
    v = torch.randn((1, KV, S, hd), generator=gen, device="cuda")
    return q.to(dtype), k.to(dtype), v.to(dtype)


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
    from repro_torch.kernels import census as CS
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
        work = CS.launch_work("flash_attention", B=1, H=H, KV=KV, sq=S,
                              sk=S, hd=hd, elem=q.element_size(),
                              causal=True, window=None)
        products = 3 if name == "bf16" else 6
        t["bound_ms"], t["bound_by"] = bound(work)
        # the same products once each, on the f32 CUDA cores
        t["f32_bound_ms"] = bound(work, peak_ops("fp32"),
                                  Fraction(1, products))[0]
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


def _dpa_flash_misses(err, want, codes, v, live, fmt="fp8_e4m3"):
    """-> (outputs past their bound, flipped p codes).  Each output may be
    off by one bf16 ulp of itself plus FLASH_F32_RTOL of its row's largest
    output.  A flipped code moves its probability by |p0 - p1| <= the gap
    of the two values / T (p <= 1, scale amax / T; T the attention format
    fmt's target, 448 for E4M3; the codes are E4M3 bytes, or fp16 values
    at fp16 attention), and moves the
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
        from repro_torch.core.formats import get_format

        def value(c):
            return (c.view(torch.float8_e4m3fn) if c.dtype == torch.uint8
                    else c).float()
        gap = (value(codes[0][idx]) - value(codes[1][idx])).abs()
        moved = torch.zeros(err.shape[:-1], device=err.device)
        moved.index_put_(idx[:-1], gap / get_format(fmt).quant_target,
                         accumulate=True)
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
    from repro_torch.kernels import census as CS
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
            work = CS.launch_work("dpa_flash_attention", B=1, H=H, KV=KV,
                                  sq=S, sk=S, hd=hd, q_bytes=2,
                                  kv_row_bytes=hd * 2, causal=True,
                                  window=window)
            t["bound_ms"], t["bound_by"] = bound(work)
            t["fp16_bound_ms"] = bound(work, peak_ops("fp16"))[0]
            # this design runs PV twice (p split into two fp16 pieces)
            t["fp16_bound_pv_twice_ms"] = bound(work, peak_ops("fp16"),
                                                Fraction(3, 2))[0]
            t["live_logits"] = live     # each an expf and an IEEE division
            pre = lambda: (FA._prepass(k, fmt_kv),  # noqa: E731
                           FA._prepass(v, fmt_kv))
            t["prepass_ms"] = median_ms(pre)
            t["prepass_device_ms"] = device_ms(pre)
            # two row-quantizer launches, K and V
            t["prepass_bound_ms"] = 2 * bound(CS.launch_work(
                "quantize_pack_rows", M=KV * S, K=hd, x_bytes=2))[0]
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
    from repro_torch.kernels import census as CS
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
            t["bound_ms"], t["bound_by"] = bound(
                CS.launch_work("quantize_pack_rows", M=M, K=K, x_bytes=2)
                if fmt == "packed" else
                CS.launch_work("quantize_rows", M=M, K=K, x_bytes=2,
                               fmt=fmt))
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

# the tuner (phase 2's sweep, phase 3a's engine pseudo-op and tuned run)
TUNE_DB = ROOT / "build" / "tuned_smoke.json"
TUNE_OPS = ("matmul", "grouped_matmul", "flash_attn", "paged_decode",
            "verify_attn", "quantize_pack")
TUNED_RUN = 2                     # SERVE_ORDER's second graphed run
# the serving paths' configs and the policies they serve under (None:
# every policy of `tuner.OP_POLICIES`; fp4_dpa_packed is path B's alone)
TUNE_PATHS = (("qwen3-4b", ("w4a8_kv4_attn8", "fp8_dpa", "fp32")),
              ("granite-moe-1b-a400m", None))


def _tune_groups(db) -> dict:
    """A DB's records by (op, policy, class, shape, route), fastest
    first."""
    groups = {}
    for rec in db["records"].values():
        key = (rec["op"], rec["policy"], rec["shape_class"],
               tuple(rec["shape"]), rec["route"])
        groups.setdefault(key, []).append(rec)
    return {k: sorted(v, key=lambda r: (r["us"], json.dumps(r["knobs"])))
            for k, v in sorted(groups.items())}


def _knobs_str(knobs) -> str:
    return " ".join(f"{k} {v}" for k, v in sorted(knobs.items())) or "static"


def run_tuner(gen):
    """The tuner's smoke space at the serving paths' shapes (qwen3-4b and
    granite-moe-1b at full width under the policies they serve, every op
    but the engine pseudo-op, which phase 3a measures on its model;
    `TUNE_PATHS`), measured on the card into a
    fresh DB (`TUNE_DB`): each record printed with its device us a call,
    its spread and the static plan marked, each (route, shape)'s static /
    tuned ratio (>= 1: the static plan is always measured).  Then, with
    the DB active, every key resolves to a tuned entry, and each tuned
    plan that differs from the static one is held once against the plain
    version (`hold_tuned`).  -> the phase's summary."""
    from repro_torch.core import exec_plan
    from repro_torch.core.policy import get_policy
    from repro_torch.runtime import tuner
    t0 = time.monotonic()
    TUNE_DB.parent.mkdir(parents=True, exist_ok=True)
    if TUNE_DB.exists():
        TUNE_DB.unlink()
    tuner.clear_caches()
    measured = 0
    for name, policies in TUNE_PATHS:
        measured += tuner.run_sweep(
            str(TUNE_DB), smoke=True, device="cuda", ops=TUNE_OPS,
            configs=(name,), policies=policies)["measured"]
    t_sweep = time.monotonic() - t0
    groups = _tune_groups(tuner.load_db(str(TUNE_DB)))
    rows = []
    for (op, policy, cls, shape, route), recs in groups.items():
        static = next(r for r in recs if not r["knobs"])
        best = recs[0]
        for r in recs:
            print(f"tuner {op}/{route} {policy} {cls} {list(shape)} "
                  f"{_knobs_str(r['knobs'])}: {r['us'] / 1e3:.5f} device ms"
                  f" (spread {r['spread']:.3f}, {r['reps']} replays of "
                  f"{r['calls']} call(s){', cold' if r.get('cold') else ''})"
                  + (" <- the static plan" if r is static else ""))
        ratio = static["us"] / best["us"]
        rows.append({"op": op, "route": route, "policy": policy,
                     "class": cls, "shape": list(shape),
                     "static_ms": static["us"] / 1e3,
                     "tuned_ms": best["us"] / 1e3,
                     "tuned_knobs": best["knobs"], "ratio": ratio,
                     "candidates": len(recs)})
        print(f"tuner {op}/{route} {policy} {list(shape)}: tuned "
              f"{_knobs_str(best['knobs'])} {best['us'] / 1e3:.5f} ms, "
              f"static {static['us'] / 1e3:.5f} ms: static / tuned "
              f"{ratio:.3f} over {len(recs)} plans")
    before = exec_plan.use_tuned_db(str(TUNE_DB))
    held = []
    try:
        for (op, policy, cls, shape, route), recs in groups.items():
            ctx = recs[0]["ctx"]
            entry = exec_plan.resolve(op, policy, **ctx)
            if not entry.tuned or entry.name != route:
                raise AssertionError(f"tuner: {op} {policy} {list(shape)} "
                                     f"resolved {entry.name}, tuned "
                                     f"{entry.tuned}, with its DB active")
            knobs = dict(entry.tuned_knobs)
            pol = get_policy(policy)
            if knobs and entry.plan(pol, ctx, **knobs) != entry.plan(pol,
                                                                     ctx):
                held.append(hold_tuned(op, route, pol, ctx, knobs, gen))
    finally:
        exec_plan.use_tuned_db(before)
    seconds = time.monotonic() - t0
    static_best = sum(1 for r in rows if not r["tuned_knobs"])
    top = max(rows, key=lambda r: r["ratio"])
    print(f"tuner phase: {seconds:.1f} s ({t_sweep:.1f} s the sweep of "
          f"{measured} configs); the static plan fastest in "
          f"{static_best} of {len(rows)} (route, shape)s; largest static / "
          f"tuned {top['ratio']:.3f} ({top['op']}/{top['route']} "
          f"{top['shape']} {_knobs_str(top['tuned_knobs'])}); "
          f"{len(held)} tuned plans held against the plain version")
    return {"seconds": seconds, "sweep_seconds": t_sweep,
            "measured": measured, "keys": len(rows),
            "static_best": static_best, "largest_ratio": top["ratio"],
            "largest_ratio_at": {k: top[k] for k in (
                "op", "route", "shape", "tuned_knobs")},
            "held": held, "table": rows, "env": tuner.env_fingerprint()}


def hold_tuned(op, route, pol, ctx, knobs, gen) -> dict:
    """One launch with the tuned knobs against the kernel's plain version
    on fresh inputs at the key's shape: bit for bit for the quantizers
    and the prequant kernel's int8 route (packed E2M1 x packed E2M1), the
    fused route's pin, and the flash routes' pins at the tuned bk (DPA:
    `_dpa_flash_misses`, at most DPA_FLASH_MAX_FLIPS of the live p codes
    flipped)."""
    import torch
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import quantize as QZ
    from repro_torch.kernels.ops import prep_grouped_weights, prep_weights
    what = f"tuned {op}/{route} {_knobs_str(knobs)}"
    res = {"op": op, "route": route, "knobs": knobs}
    if route in ("cuda_fused", "cuda_grouped_fused"):
        E, M, K, N = ctx.get("e", 1), ctx["m"], ctx["k"], ctx["n"]
        kw = dict(fmt_x=pol.fmt_acts, fmt_w=pol.fmt_weights)
        w = torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5
        x = torch.randn((E, M, K), generator=gen, device="cuda").to(
            torch.bfloat16)
        if E == 1:
            prep = prep_weights(w[0].to(torch.bfloat16), pol)
            got = DM.dpa_matmul_fused(x[0], prep["wq"], prep["sw"],
                                      pack_w=prep["pack_w"], **kw, **knobs)
            want = DM.dpa_matmul_fused_ref(x[0], prep["wq"], prep["sw"],
                                           pack_w=prep["pack_w"], **kw)
        else:
            prep = prep_grouped_weights(w, pol)
            got = GM.dpa_grouped_matmul_fused(
                x, prep["wq"], prep["sw"], pack_w=prep["pack_w"], **kw,
                **knobs)
            want = GM.dpa_grouped_matmul_fused_ref(
                x, prep["wq"], prep["sw"], pack_w=prep["pack_w"], **kw)
        err, ok = _close(got, want)
        res.update(shape=[E, M, K, N], max_abs_err=err)
    elif route in ("cuda_prequant", "cuda_grouped_prequant"):
        E, M, K, N = ctx.get("e", 1), ctx["m"], ctx["k"], ctx["n"]
        xq = torch.randint(0, 256, (E, M, K // 2), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        wq = torch.randint(0, 256, (E, K // 2, N), generator=gen,
                           device="cuda", dtype=torch.int32).to(torch.uint8)
        sx = torch.rand((E, M, 1), generator=gen, device="cuda") + 0.05
        sw = torch.rand((E, 1, N), generator=gen, device="cuda") + 0.05
        got = GM.dpa_grouped_matmul_prequant(xq, wq, sx, sw, **FP4_PACKED,
                                             **knobs)
        want = GM.dpa_grouped_matmul_prequant_ref(xq, wq, sx, sw,
                                                  **FP4_PACKED)
        ok = bool(torch.equal(got, want))
        res.update(shape=[E, M, K, N], bit_for_bit=ok,
                   max_abs_err=float((got - want).abs().max()))
    elif route == "cuda_dpa_flash":
        H, KV, S, hd = ctx["heads"], ctx["kv_heads"], ctx["sq"], ctx["hd"]
        q, k, v = _attn_inputs(gen, H, KV, S, hd, torch.bfloat16)
        codes = [torch.zeros((1, H, S, S), dtype=torch.uint8, device="cuda")
                 for _ in range(2)]
        kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv)
        got = FA.dpa_flash_attention(q, k, v, p_codes=codes[0], **kw,
                                     **knobs)
        want = FA.dpa_flash_attention_ref(q, k, v, p_codes=codes[1],
                                          bk=min(knobs["bk"], S), **kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        mask = FA._mask(S, S, True, None, "cuda")
        live = H * int(mask.sum())
        bad, flips = _dpa_flash_misses(err, want.float(), codes, v, mask)
        del codes
        ok = not bad and flips <= DPA_FLASH_MAX_FLIPS * live
        res.update(shape=[H, KV, S, hd], max_abs_err=float(err.max()),
                   p_codes_flipped=[flips, live])
    elif route == "cuda_f32_flash":
        H, KV, S, hd = ctx["heads"], ctx["kv_heads"], ctx["sq"], ctx["hd"]
        q, k, v = _attn_inputs(gen, H, KV, S, hd, torch.bfloat16)
        got = FA.flash_attention(q, k, v, **knobs)
        want = FA.flash_attention_ref(q, k, v)
        err = (got.float() - want.float()).abs()
        ok = bool((err <= _bf16_ulp(want.float()) + FLASH_F32_RTOL
                   * float(want.float().abs().max())).all())
        res.update(shape=[H, KV, S, hd], max_abs_err=float(err.max()))
    elif route in ("cuda_quantize_rows", "cuda_quantize_pack"):
        x = torch.randn((ctx["m"], ctx["k"]), generator=gen,
                        device="cuda").to(torch.bfloat16)
        if ctx["pack"]:
            got = QZ.quantize_pack_rows(x, **knobs)
            want = QZ.quantize_pack_rows_ref(x)
        else:
            got = QZ.quantize_rows(x, fmt=ctx["fmt"], **knobs)
            want = QZ.quantize_rows_ref(x, fmt=ctx["fmt"])
        ok = all(torch.equal(g.view(torch.uint8), w.view(torch.uint8))
                 for g, w in zip(got, want))
        res.update(shape=[ctx["m"], ctx["k"]], bit_for_bit=ok,
                   max_abs_err=0.0 if ok else None)
    else:
        raise AssertionError(f"{what}: no plain version to hold it to")
    if not ok or not bool(torch.isfinite(got if torch.is_tensor(got)
                                         else got[1]).all()):
        raise AssertionError(f"{what} at {res.get('shape')}: {res}")
    print(f"{what} at {res['shape']}: held against the plain version "
          f"({'bit for bit' if res.get('bit_for_bit') else 'max_abs_err ' + format(res['max_abs_err'], '.3g')}"
          + (f", {res['p_codes_flipped'][0]} of {res['p_codes_flipped'][1]}"
             " live p codes flipped" if "p_codes_flipped" in res else "")
          + ")")
    return res


def tune_engine(cfg, params) -> dict:
    """The tuner's engine pseudo-op on the card: qwen3-4b at full width
    under `tuner.ENGINE_POLICY` on phase 3a's weights, phase 3a's
    geometry (`tuner.CARD_ENGINE_GEOMETRY`) at page sizes 8 and 16 (the
    smoke grid), into `TUNE_DB`; the full grid's speculative points that
    `check_verify_rows` refuses for the policy's linears, which the card
    leaves out, are printed."""
    from repro_torch.models import build_model
    from repro_torch.runtime import tuner
    t0 = time.monotonic()
    emodel = build_model(cfg.replace(policy=tuner.ENGINE_POLICY),
                         device="cuda")
    stats = tuner.run_sweep(str(TUNE_DB), smoke=True, device="cuda",
                            ops=(tuner.ENGINE_OP,),
                            engine_fixture=(emodel, params))
    points = {}
    for rec in tuner.load_db(str(TUNE_DB))["records"].values():
        if rec["op"] == tuner.ENGINE_OP:
            points[_knobs_str(rec["knobs"])] = rec["us"]
            print(f"tuner engine {tuner.ENGINE_POLICY} "
                  f"{_knobs_str(rec['knobs'])}: {rec['us']:.1f} us a "
                  f"generated token (best of {rec['reps']} graphed runs, "
                  f"spread {rec['spread']:.3f})")
    best = tuner.best_engine_knobs(str(TUNE_DB))
    # the full grid's speculative points, which the card leaves out
    refused = tuner.engine_points(tuner.ENGINE_KNOB_GRID, "cuda",
                                  tuner.CARD_ENGINE_GEOMETRY)[1]
    seconds = time.monotonic() - t0
    print(f"tuner engine pseudo-op: {seconds:.1f} s, {stats['measured']} "
          f"points, best {best}; left out: {refused or 'none'}")
    return {"seconds": seconds, "us_per_token": points, "best": best,
            "refused": refused}


def check_tuned_run(cfg, ecfg, rep, counts, want_counts) -> bool:
    """The tuned engine run's plans: the decode step's paged route and
    every linear resolved "tuned", on the kernels, with the launch counts
    of the untuned graphed run.  -> whether every tuned split-K plan is
    the static one (then the tokens must be the untuned runs')."""
    from repro_torch.core import exec_plan
    from repro_torch.core.policy import get_policy
    pol = get_policy(cfg.policy)
    plans = rep["linear_plans"]
    if rep["decode_selection"] != "tuned" or any(
            p["selection"] != "tuned" or p["route"] != "cuda_fused"
            for p in plans.values()):
        raise AssertionError(f"tuned run: decode {rep['decode_selection']},"
                             f" linears {plans}")
    if counts != want_counts:
        raise AssertionError(f"tuned run launches {counts}, untuned "
                             f"{want_counts}")
    fused = exec_plan.route("matmul", "cuda_fused")
    same = True
    for shape, p in plans.items():
        k, n = map(int, shape.split("x"))
        ctx = dict(m=ecfg.max_batch, k=k, n=n)
        static, tuned = fused.plan(pol, ctx), fused.plan(pol, ctx,
                                                         **p["knobs"])
        same &= static == tuned
        print(f"tuned run {shape}: {_knobs_str(p['knobs'])} -> {tuned} "
              f"(static {static})")
    print(f"tuned run: every plan tuned, launches = the untuned graphed "
          f"run's; every split-K plan the static one: {same}")
    return same


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
    (`repro_torch.kernels.counters`, without their work; a graph replay
    adds its capture's delta)."""
    from repro_torch.kernels import counters
    return counters.launches(counters.snapshot())


# the fused wrappers, whose launches are also counted by activation format
FUSED_WRAPPERS = ("dpa_matmul_fused", "dpa_grouped_matmul_fused")
FUSED_X_FMTS = ("fp8_e4m3", "fp4_e2m1", "fp16")


def check_counts(what, got, want):
    """Every kernel's launches over one path equal the count its config
    and run imply (0 for the kernels the path does not run).  A `want`
    that names no activation format of a fused wrapper takes all its
    launches at E4M3 (every policy on the fused kernel but path L's)."""
    want = dict(want)
    for w in FUSED_WRAPPERS:
        if not any(f"{w}.{f}" in want for f in FUSED_X_FMTS):
            want[f"{w}.fp8_e4m3"] = want.get(w, 0)
    want = {k: want.get(k, 0) for k in got}
    if got != want:
        raise AssertionError(f"{what} launches {got}, want {want}")
    print(f"launches on the {what} path: " + ", ".join(
        f"{k} {v}" for k, v in got.items() if v))


# the kernels a replay's profile window reports shares of
REPLAY_WATCH = ("dpa_fused_kernel", "paged_decode", "dpa_prequant_kernel")


def check_replay(label, graph):
    """One profiler window over a single replay of a captured step: each
    kernel runs as often as the capture's counter delta says (a replay
    adds that delta to the counters), so the counts on the graphed paths
    rest on the trace, not on the arithmetic alone (`matched_window`,
    which tries again where the profiler lost a record).  -> the first
    window's profile (its times are the replay's alone), with the pads of
    the matching one."""
    from repro_torch.kernels import counters
    what = f"{label} (one replay)"
    first = profile_window(what, graph.run, watch=REPLAY_WATCH,
                           require=True, timed=5)
    matched = matched_window(what, first, graph.run)
    want = {k: v for k, v in counters.launches(graph.delta).items() if v}
    if counters.launches(matched["work"]) != want:
        raise AssertionError(f"{label}: one replay counted "
                             f"{counters.launches(matched['work'])}, its "
                             f"capture {want}")
    print(f"  {label}: one replay's kernels = the capture's delta")
    return dict(first, matched_after_pads=matched["matched_after_pads"])


# every kernel's name in a profile, and the counter keys whose launches
# each name stands for (`kernels.counters`): a route table's rows
PROFILE_ROUTES = {
    "dpa_fused_kernel": ("dpa_matmul_fused.splitk",
                         "dpa_grouped_matmul_fused.splitk"),
    "fused_tiled_kernel": ("dpa_matmul_fused.tiled",
                           "dpa_grouped_matmul_fused.tiled"),
    "act_quant_kernel": ("dpa_act_quant",),
    "dpa_prequant_kernel": ("dpa_matmul_prequant",
                            "dpa_grouped_matmul_prequant"),
    "paged_decode_kernel": ("paged_decode_attention",),
    "dpa_flash": ("dpa_flash_attention",),      # both head-dim layouts
    "flash_tc_kernel": ("flash_attention",),
    "kv_split_kernel": ("flash_attention.prepass",),
    "quantize_rows_kernel": ("quantize_rows", "quantize_pack_rows")}
# small kernels launched before a retried window's call (`matched_window`)
REPLAY_PADS = (0, 3, 17, 61, 5, 29, 113, 251)
# a route's profiled device ms may not read below its summed bound / this
ROUTE_FLOOR = 1.05
# every path's route table and cell, in the order the phases ran
ROOFLINE = []


def matched_window(label, prof, fn):
    """A profile of one call of fn (`profile_window`) whose records of
    each route table's kernels equal the launches the counters took over
    it: prof itself, or a window tried again after a few small kernels
    (`REPLAY_PADS`), which move the records in the profiler's buffers.
    The profiler loses a record now and then, the same one in identical
    windows of a run (on an H100 the granite prefill chunk's replay read
    166-167 of 168 fused launches in one to four windows in a row, eager
    windows up to 3 of 252; most losses fall at a profiling run's start,
    which `PROFILE_LEAD` takes).  A lost record never passes as a fast kernel:
    none of eight windows matching fails the run."""
    import torch
    seen = []
    for k in REPLAY_PADS:
        if k:
            pad = torch.zeros((), device="cuda")

            def padded(k=k, pad=pad):
                for _ in range(k):
                    pad.add_(1)
                return fn()
            prof = profile_window(f"{label} (after {k} small kernels)",
                                  padded, require=True, warm=False)
        got = {r: n for r, (n, _) in prof["routes"].items()}
        want = {r: sum(prof["work"].get(key, 0) for key in r.split(" + "))
                for r in got}
        if got == want:
            return dict(prof, matched_after_pads=k)
        seen.append({r: (got[r], want[r]) for r in got if got[r] != want[r]})
        print(f"  {label}: records (seen, counted) {seen[-1]}; trying again")
    raise AssertionError(f"{label}: the profiler's records (seen, counted) "
                         f"{seen} in {len(REPLAY_PADS)} windows")


def check_route_floor(label, rows):
    """No impossible reading: each route's profiled device ms is at least
    its summed bound / ROUTE_FLOOR."""
    low = [r for r in rows if r["device_ms"] is not None
           and r["device_ms"] < r["bound_ms"] / ROUTE_FLOOR]
    if low:
        raise AssertionError(f"{label}: device ms below the bound / "
                             f"{ROUTE_FLOOR}: " + "; ".join(
                                 f"{r['route']} {r['device_ms']:.5f} ms < "
                                 f"{r['bound_ms']:.5f}" for r in low))


def check_linear_census(what, delta, cfg, tokens):
    """The runtime census against the analytic one: the tiled route's
    operations over one pass of `tokens` tokens equal 2 tokens layers
    (proj + mlp) MACs a token of `launch.analytic`, exactly (integers).
    -> the operations."""
    from repro_torch.launch import analytic as AN
    proj, _ = AN._attn_macs_per_token(cfg, tokens)
    want = 2 * tokens * cfg.n_layers * (proj + AN._mlp_macs_per_token(cfg))
    got = delta.get("dpa_matmul_fused.tiled:ops", 0)
    if got != want:
        raise AssertionError(f"{what}: the tiled route's census counts "
                             f"{got} operations, the analytic census "
                             f"{want}")
    print(f"  {what}: the tiled route's {got} operations = 2 x {tokens} "
          f"x {cfg.n_layers} x (proj + mlp) of the analytic census")
    return got


def cell_report(label, cfg, kind, seq, batch, wall_ms):
    """`launch.roofline.cell_roofline` at (kind, seq, batch) against a
    measured wall (ms): the share of the bound at bf16 and at the DPA
    peak."""
    from repro_torch.launch.roofline import cell_roofline
    c = {k: v for k, v in cell_roofline(cfg, kind, seq, batch).items()
         if k != "suggest"}
    c.update(wall_ms=wall_ms, share_bf16=c["bound_bf16_s"] * 1e3 / wall_ms,
             share_dpa=c["bound_s"] * 1e3 / wall_ms)
    print(f"  cell {label}: {cfg.name} {kind} seq {seq} batch {batch}, "
          f"{c['flops']:.4g} analytic FLOPs, {c['hbm_bytes']:.4g} bytes; "
          f"bound {c['bound_s'] * 1e3:.3f} ms at the {c['dpa_fmt']} peak "
          f"({c['dominant']}), {c['bound_bf16_s'] * 1e3:.3f} at bf16; wall "
          f"{wall_ms:.3f} ms, of which the bound is {c['share_dpa']:.2%} "
          f"at the DPA peak and {c['share_bf16']:.2%} at bf16")
    return c


def path_roofline(label, prof, fn, cell=None, wall_ms=None):
    """Where one profiled window's time goes against the bound: its route
    table (`launch.roofline.route_table`: launches, summed bound, device
    ms, loss) from a window whose records match the counters
    (`matched_window`), held to `check_route_floor`; and, given cell =
    (cfg, kind, seq, batch), `cell_report` against wall_ms (default: the
    window's unprofiled wall, else its profiled one).  Kept in ROOFLINE.
    -> the matched window's profile."""
    from repro_torch.launch.roofline import route_table
    wall_ms = wall_ms or prof.get("unprofiled_wall_ms") or prof["wall_ms"]
    prof = matched_window(label, prof, fn)
    rows = route_table(prof["work"], {r: ms for r, (_, ms)
                                      in prof["routes"].items()})
    check_route_floor(label, rows)
    out = {"path": label, "routes": rows}
    print(f"roofline {label} (records matched after "
          f"{prof['matched_after_pads']} pads): " + ("no kernel launch"
                                                     if not rows else ""))
    for r in rows:
        print(f"    {r['route']}: {r['launches']} launches, device "
              f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['ratio']:.2f}x), loss {r['loss_ms']:.4f} ms")
    if cell is not None:
        out["cell"] = cell_report(label, *cell, wall_ms)
    ROOFLINE.append(out)
    return prof


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


SERVE_ORDER = ("eager", "graphed", "graphed")
# requests of an engine's eager reference run: the first 2 of phase 3's 8
# (a request's tokens do not depend on the batch it rides in: phase 3g
# serves two requests alone against their in-batch tokens)
EAGER_REQUESTS = 2


def workload(cfg, **kw):
    """Phase 3's 8 requests: prompts of 64-192 tokens, 16-32 new tokens,
    all at t=0 (`kw`: `synthetic_workload`'s shared_prefix)."""
    from repro_torch.launch.engine import synthetic_workload
    return synthetic_workload(8, vocab=cfg.vocab_size, seed=0, rate=0,
                              prompt_range=(64, 192), gen_range=(16, 32),
                              **kw)


def _fused_linears(pol) -> bool:
    """Whether a policy's linears run the fused kernel (else plain
    fake-quant or f32 products, no kernel)."""
    from repro_torch.core import exec_plan
    return exec_plan.resolve("matmul", pol,
                             w_dtype="float32").name == "cuda_fused"


def engine_counts(cfg, rep, rungs=()) -> dict:
    """The launches an engine run with report `rep` implies: every
    projection of every serving-policy model call (prefill chunks, decode
    steps, verify steps) and of every draft step whose policy runs the
    fused kernel on the split-K route; one paged decode a layer a decode,
    draft or verify step, counted by its attention format, the verify
    steps' also as folds.  `rungs`: (draft policy, draft steps run)."""
    from repro_torch.core.policy import get_policy
    dense, experts = per_call_projections(cfg)
    L = cfg.n_layers
    serve = rep["decode_steps"] + rep.get("verify_steps", 0)
    # the serving policy's model calls, where its linears run the fused
    # kernel (path M's f32 linears do not)
    calls = (rep["prefill_calls"] + serve
             if _fused_linears(get_policy(cfg.policy)) else 0) + sum(
        n for pol, n in rungs if _fused_linears(pol))
    want = {"dpa_matmul_fused": dense * L * calls,
            "dpa_matmul_fused.splitk": dense * L * calls,
            "dpa_grouped_matmul_fused": experts * L * calls,
            "dpa_grouped_matmul_fused.splitk": experts * L * calls,
            "paged_decode_attention": L * (serve + sum(n for _, n in rungs)),
            "paged_decode_attention.verify": L * rep.get("verify_steps", 0)}
    by_fmt = {get_policy(cfg.policy).fmt_attn: serve}
    for pol, n in rungs:
        by_fmt[pol.fmt_attn] = by_fmt.get(pol.fmt_attn, 0) + n
    for fmt, n in by_fmt.items():
        want[f"paged_decode_attention.{fmt}"] = L * n
    return want


def spec_rungs(engine):
    """(policy, draft steps run) of each of an engine's draft rungs."""
    return [(r.pol, engine.rung_rounds[i] * r.k)
            for i, r in enumerate(engine.rungs)]


def serve_once(what, cfg, model, params, ecfg, reqs, sampler=None,
               graphs=True, spec=None, adaptive=None, ctrl_step=None):
    """One engine run over `reqs`, the launch counters zeroed just before
    `Engine.run` and read just after: every request served in full, its
    pages back (but for resident cached prefixes) and its reservation
    released, the launch counts the run implies.  `spec` / `adaptive`
    serve speculatively (`ctrl_step` replaces the controller).  ->
    (report, counts, engine)."""
    import numpy as np
    import torch
    from repro_torch.launch.engine import Engine

    gc.collect()                  # earlier engines' graphs and pools
    t0 = time.monotonic()
    engine = Engine(model, params, ecfg, sampler=sampler, device="cuda",
                    graphs=graphs, spec=spec, adaptive=adaptive)
    if ctrl_step is not None:
        engine._ctrl_step = ctrl_step
    torch.cuda.synchronize()
    setup_s = time.monotonic() - t0
    zero_counts()
    rep = engine.run(reqs)
    torch.cuda.synchronize()
    counts = read_counts()
    for r in reqs:
        if r.n_generated != r.max_new:
            raise AssertionError(f"{what}: request {r.rid}: {r.n_generated} "
                                 f"of {r.max_new} tokens")
    resident = engine.prefix.n_pages if engine.prefix is not None else 0
    if engine.alloc.in_use != resident or np.any(engine._table != 0) or \
            engine.alloc.reserved:
        raise AssertionError(f"{what}: pages not evicted / table not back "
                             "to scratch / reservations left")
    check_counts(what, counts, engine_counts(cfg, rep, spec_rungs(engine)))
    dense, experts = per_call_projections(cfg)
    if engine.rungs:
        print(f"  = {dense * cfg.n_layers} dense per kernel-policy model "
              f"call ({rep['prefill_calls']} prefill chunks, "
              f"{rep['verify_steps']} verify steps, the draft steps of "
              "the rungs on the kernel), "
              f"{cfg.n_layers} paged per draft or verify step: draft steps "
              + ", ".join(f"{p.fmt_attn} {n}" for p, n in
                          spec_rungs(engine)))
    else:
        print(f"  = {dense * cfg.n_layers} dense"
              + (f" + {experts * cfg.n_layers} grouped" if experts else "")
              + f" per model call x "
              f"{rep['prefill_calls'] + rep['decode_steps']} calls, "
              f"{cfg.n_layers} paged per decode step x "
              f"{rep['decode_steps']} steps")
    rep["setup_s"] = setup_s
    print(f"engine ({what}): {_report_line(rep)}; set-up {setup_s:.2f} s "
          "(not in the wall)")
    for name, st in rep.get("capture", {}).items():
        print(_capture_line(name, st))
    return rep, counts, engine


def run_engine(cfg, ecfg, tuned=False):
    """The engine over 8 requests with its steps as CUDA graphs, and over
    the first `EAGER_REQUESTS` eagerly (`graphs=False`, the reference), in
    turns (`SERVE_ORDER`): every request's tokens equal in every run that
    serves it, the launch counts the config
    implies on each run, and one profiler window over a single replay of
    each graph of the first graphed run holding its kernels to the
    capture's counts.  The first run of each mode is the one reported
    (the graphed one's counts are the path's), beside every run's
    tokens/s.

    `tuned`: the tuner's engine pseudo-op is measured on this model's
    weights into `TUNE_DB` (`tune_engine`), and run `TUNED_RUN` (the
    second graphed) serves with that DB active (`check_tuned_run`): its
    tokens must equal the other runs' where every tuned split-K plan is
    the static one, else two of its requests are teacher-forced under the
    DB (the first token and at least half must agree)."""
    import numpy as np
    from repro_torch.core import exec_plan
    from repro_torch.launch.serve import generate

    model, params = build(cfg)
    restore = finite_steps(model)
    tune = tune_engine(cfg, params) if tuned else None
    reps, served = {"eager": [], "graphed": []}, []
    for i, mode in enumerate(SERVE_ORDER):
        reqs = workload(cfg)[:EAGER_REQUESTS if mode == "eager" else None]
        db = str(TUNE_DB) if tuned and i == TUNED_RUN else None
        before = exec_plan.use_tuned_db(db)
        try:
            rep, counts, engine = serve_once(
                f"{cfg.name} engine ({mode}{', tuned' if db else ''})", cfg,
                model, params, ecfg, reqs, graphs=mode == "graphed")
        finally:
            exec_plan.use_tuned_db(before)
        if db:
            tune["same_splits"] = check_tuned_run(
                cfg, ecfg, rep, counts, reps["graphed"][0]["counts"])
            tune["run"] = {k: rep[k] for k in (
                "tokens_per_s", "decode_selection", "linear_plans",
                "p50_latency_s", "p50_ttft_s")}
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
        # the first graphed run against the eager run on its requests, a
        # later one against the first graphed run on all of them
        ref = served[0] if i == 1 else served[1]
        differ = [a.rid for a, b in zip(ref, run)
                  if a.out_tokens != b.out_tokens]
        if tune is not None and i == TUNED_RUN:
            tune["requests_differ"] = differ
            if not tune["same_splits"]:
                tune["teacher_forced"] = tuned_replay(model, params, ecfg,
                                                      run)
                continue
        if differ:
            raise AssertionError(f"{cfg.name}: run {i} ({SERVE_ORDER[i]}) "
                                 f"gave other tokens than run {int(i > 1)} "
                                 f"({SERVE_ORDER[int(i > 1)]}) for "
                                 f"requests {differ}")
    rep, reqs = reps["graphed"][0], served[SERVE_ORDER.index("graphed")]
    print(f"{cfg.name}: every request's tokens equal in all "
          f"{len(SERVE_ORDER)} runs ({' '.join(SERVE_ORDER)}; "
          f"{rep['gen_tokens']} tokens each graphed, the eager run the "
          f"first {EAGER_REQUESTS} requests)" if tune is None else
          f"{cfg.name}: {len(tune['requests_differ'])} of {len(reqs)} "
          f"requests' tokens differ in the tuned run {TUNED_RUN} (every "
          f"split the static one: {tune['same_splits']}), none in the "
          f"others ({' '.join(SERVE_ORDER)}; {rep['gen_tokens']} tokens "
          "each)")
    counts = rep.pop("counts")
    rep["eager"] = reps["eager"][0]
    rep["tokens_per_s_runs"] = {m: [r["tokens_per_s"] for r in rs]
                                for m, rs in reps.items()}
    if tune is not None:
        rep["tuned"] = tune
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
    # agree (the margins where they differ are reported beside).  One
    # request: each replay steps eagerly
    rep["agreement"] = []
    for r in reqs[:1]:
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
    return model, params, rep, counts, [r.out_tokens for r in reqs]


def tuned_replay(model, params, ecfg, reqs) -> list:
    """Where a tuned split differs from the static one: two requests of
    the tuned run teacher-forced through the static path under the DB
    (the same plans): the first token must be the run's, and at least
    half of the tokens."""
    from repro_torch.core import exec_plan
    out = []
    before = exec_plan.use_tuned_db(str(TUNE_DB))
    try:
        for r in reqs[:2]:
            tf = teacher_forced(model, params, r, ecfg.s_max,
                                ecfg.prefill_chunk)
            if not tf["first_token_agrees"] or 2 * tf["agree"] < tf["tokens"]:
                raise AssertionError(f"tuned run, request {r.rid}: "
                                     f"teacher-forced replay {tf}")
            out.append(dict(tf, rid=r.rid))
    finally:
        exec_plan.use_tuned_db(before)
    return out


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
    cell = (cfg, "decode", prompt_len + n_new, n_prompts)
    eager = Step(step, bufs).run
    prof = {"eager": profile_window(f"{label}, eager", eager,
                                    watch=("dpa_prequant_kernel",), timed=3)}
    path_roofline(f"{label}, eager", prof["eager"], eager, cell)
    graph = StepGraph(step, bufs, name="serve step")
    print(_capture_line("serve step (profiled)", graph.stats))
    prof["graphed"] = check_replay(f"{label}, graphed", graph)
    path_roofline(f"{label}, graphed", prof["graphed"], graph.run, cell)
    res["graphed"]["profile"] = prof
    counts = res["graphed"].pop("counts")
    return counts, {**res["graphed"], "eager": res["eager"]}


# -----------------------------------------------------------------------------
# phase 3g-i: sampled decoding, the prefix cache, the front end
# -----------------------------------------------------------------------------

SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95, seed=7)
ALONE = (1, 6)                    # requests also served alone
SHARED_PREFIX = 128
FRONT_END = ["--arch", "qwen3-4b", "--engine", "--policy", "w4a8_kv4_attn8",
             "--requests", "8", "--prompt-len", "192", "--gen", "32",
             "--temperature", "0.8", "--top-k", "50", "--top-p", "0.95"]
FRONT_END_LINES = ("engine: 8 reqs", "latency: p50", "ttft p50",
                   "kv-cache: peak live", "plan: decode via cuda_block_table",
                   "sample (req ")


def run_sampled(cfg, ecfg, model, params, greedy_tokens, greedy_prof):
    """Sampled decoding (temperature 0.8, top-k 50, top-p 0.95, seed 7)
    on phase 3's workload, graphed, and eagerly on its first
    `EAGER_REQUESTS`: every request's tokens equal in both runs and the
    graphed ones other than the greedy ones somewhere; two
    requests served alone get their in-batch tokens (the decode step has
    a fixed shape, so only the slot and the other rows differ); a
    temperature-0 config with a seed and top-k gives the greedy run's
    tokens; one graphed sampled decode step profiled beside the greedy
    one.  -> (report of the graphed run, its counts, profile)."""
    from repro_torch.serving.sampler import SamplerConfig

    scfg = SamplerConfig(**SAMPLED)
    runs = {}
    for mode in ("eager", "graphed"):
        reqs = workload(cfg)[:EAGER_REQUESTS if mode == "eager" else None]
        rep, counts, engine = serve_once(
            f"{cfg.name} sampled engine ({mode})", cfg, model, params, ecfg,
            reqs, sampler=scfg, graphs=mode == "graphed")
        runs[mode] = (rep, counts, [r.out_tokens for r in reqs])
        del engine
    eager, graphed = runs["eager"][2], runs["graphed"][2]
    differ = [i for i, (a, b) in enumerate(zip(eager, graphed)) if a != b]
    if differ:
        raise AssertionError(f"{cfg.name}: graphed sampled tokens differ "
                             f"from the eager run's for requests {differ}")
    if graphed == greedy_tokens:
        raise AssertionError("the sampled run gave the greedy tokens")
    print(f"{cfg.name} sampled ({SAMPLED}): graphed tokens equal the eager "
          f"run's for its {len(eager)} requests; "
          f"{sum(a != b for a, b in zip(graphed, greedy_tokens))} requests' "
          "tokens differ from greedy")
    for i in ALONE:
        alone = workload(cfg)[i]
        serve_once(f"{cfg.name} sampled engine, request {i} alone", cfg,
                   model, params, ecfg, [alone], sampler=scfg)
        if alone.out_tokens != graphed[i]:
            raise AssertionError(
                f"request {i} alone gave {alone.out_tokens}, in the batch "
                f"{graphed[i]}: an op of the sampled step is not "
                "row-invariant")
        print(f"request {i} served alone: its {len(alone.out_tokens)} "
              "tokens equal its in-batch tokens")
    reqs = workload(cfg)
    serve_once(f"{cfg.name} temperature-0 engine (seed 7, top-k 50)", cfg,
               model, params, ecfg, reqs,
               sampler=SamplerConfig(seed=7, top_k=50))
    if [r.out_tokens for r in reqs] != greedy_tokens:
        raise AssertionError("temperature 0 with a seed and top-k gave "
                             "other tokens than the greedy run")
    print("temperature 0 (seed 7, top-k 50): every request's tokens equal "
          "the greedy run's")
    prof = profile_engine(model, params, ecfg, sampler=scfg,
                          modes=("graphed",), prefill=False)["graphed"]
    s = prof["sampled decode step (B=4)"]
    g = greedy_prof["graphed"]["decode step (B=4)"]
    rep = runs["graphed"][0]
    rep["sampled_step_profile"] = s
    if s.get("busy_ms") is not None and g.get("busy_ms") is not None:
        print(f"sampled decode step, graphed: {s['busy_ms']:.3f} device ms "
              f"(greedy {g['busy_ms']:.3f}, +{s['busy_ms'] - g['busy_ms']:.3f}"
              f"), unprofiled wall {s['unprofiled_wall_ms']:.2f} ms (greedy "
              f"{g['unprofiled_wall_ms']:.2f}), {s['launches']} launches "
              f"(greedy {g['launches']}, +{s['launches'] - g['launches']}); "
              f"sampled {rep['tokens_per_s']:.2f} tok/s graphed, "
              f"{runs['eager'][0]['tokens_per_s']:.2f} eager")
    rep["eager"] = runs["eager"][0]
    return rep, runs["graphed"][1]


def run_prefix(cfg, ecfg, model, params):
    """The prefix cache on phase 3's workload behind a shared 128-token
    prefix, graphed: a cold engine against a warm one (prefix cache on);
    every request's tokens equal, the warm run's prefill skips the cached
    pages.  -> (warm report with the cold one inside, warm counts)."""
    import dataclasses

    # 128 + 192 prompt + 32 new tokens: a 24-page block table
    ecfg = dataclasses.replace(ecfg, max_pages_per_req=24, n_pages=160)
    cold_reqs = workload(cfg, shared_prefix=SHARED_PREFIX)
    cold, _, engine = serve_once(f"{cfg.name} engine, shared prefix, cold",
                                 cfg, model, params, ecfg, cold_reqs)
    del engine
    warm_reqs = workload(cfg, shared_prefix=SHARED_PREFIX)
    warm, counts, engine = serve_once(
        f"{cfg.name} engine, shared prefix, warm", cfg, model, params,
        dataclasses.replace(ecfg, prefix_cache=True), warm_reqs)
    differ = [a.rid for a, b in zip(cold_reqs, warm_reqs)
              if a.out_tokens != b.out_tokens]
    if differ:
        raise AssertionError(f"warm prefix-cache tokens differ from cold "
                             f"ones for requests {differ}")
    if warm["prefill_tokens_saved"] <= 0 or \
            warm["prefill_calls"] >= cold["prefill_calls"]:
        raise AssertionError(f"no prefill saved: warm {warm}")
    print(f"prefix cache ({SHARED_PREFIX}-token shared prefix): warm tokens "
          f"equal cold for all {len(warm_reqs)} requests; "
          f"{warm['prefix_hits']}/{warm['prefix_queries']} hits "
          f"({warm['prefix_hit_rate']:.0%}), {warm['prefill_tokens_saved']}"
          f" prefill tokens saved, {warm['prefill_calls']} prefill calls "
          f"(cold {cold['prefill_calls']}); TTFT p50 cold "
          f"{cold['p50_ttft_s'] * 1e3:.0f} ms, warm "
          f"{warm['p50_ttft_s'] * 1e3:.0f} ms")
    engine.prefix.drop_all()
    if engine.alloc.in_use != 0:
        raise AssertionError("cached prefix pages leaked")
    warm["cold"] = cold
    return warm, counts


def run_front_end(cfg):
    """`python -m repro_torch.launch.serve` with the FRONT_END arguments,
    as one `main` call on the card (its own model and weights), counters
    zeroed just before and read just after (the run's launches and the
    captures' two warm-up calls); its report lines printed and checked.
    -> (report, counts)."""
    import io
    import torch
    from repro_torch.launch import serve

    out = io.StringIO()
    zero_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rep = serve.main(FRONT_END)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    text = out.getvalue()
    print("front end: python -m repro_torch.launch.serve "
          + " ".join(FRONT_END))
    print(text, end="")
    missing = [k for k in FRONT_END_LINES if k not in text]
    if missing or rep["n_requests"] != 8 or rep["temperature"] != 0.8:
        raise AssertionError(f"front end printed no {missing}: {text}")
    # the counters also ran through the engine's construction, whose two
    # captures each made one eager warm-up call (a decode step, a prefill
    # chunk)
    want = engine_counts(cfg, rep)
    dense, _ = per_call_projections(cfg)
    for k in ("dpa_matmul_fused", "dpa_matmul_fused.splitk"):
        want[k] += 2 * dense * cfg.n_layers
    want["paged_decode_attention"] += cfg.n_layers
    want["paged_decode_attention.fp8_e4m3"] += cfg.n_layers
    check_counts("qwen3-4b front end", counts, want)
    print(f"front end: {wall:.1f} s for the call (model build, weights, "
          f"captures and the run; the run's wall {rep['wall_s']:.2f} s)")
    rep["call_s"] = wall
    return rep, counts


# -----------------------------------------------------------------------------
# phase 3j: speculative decoding and the adaptive draft ladder
# -----------------------------------------------------------------------------

# the ops the row-invariance probe records, by their names in
# repro_torch.models.layers
PROBE_OPS = ("apply_norm", "apply_linear", "rope", "apply_attention",
             "apply_mlp", "apply_unembed")
# requests of a's workload the runs with slow draft steps serve (the
# fake-quant rungs re-quantize every f32 master weight each step): the
# first four, one batch, whose greedy tokens do not depend on the rest
SPEC_ONE = 1                      # ... of the static fp4 draft, the
                                  # every-round switch and the sampled
                                  # runs (their fake-quant draft steps
                                  # take 0.15-0.5 s)
SPEC_FEW = 2                      # requests of the other spec runs,
SPEC_NEW = 8                      # each cut to this many new tokens
FRONT_END_ADAPTIVE = ["--arch", "qwen3-4b", "--engine", "--policy",
                      "w4a8_kv4_attn8", "--adaptive-draft", "--requests", "2",
                      "--prompt-len", "96", "--gen", "8"]


@contextlib.contextmanager
def recorded_ops():
    """Record every call of `PROBE_OPS` (but a call made inside a call of
    the same op: the verify pass's per-row pieces) as (name, input,
    output) in the order the calls return; the input is the call's first
    tensor argument."""
    import torch
    from repro_torch.models import layers as L
    seen, saved = [], {n: getattr(L, n) for n in PROBE_OPS}
    active = dict.fromkeys(PROBE_OPS, 0)

    def wrap(name, fn):
        def rec(*args, **kw):
            active[name] += 1
            try:
                out = fn(*args, **kw)
            finally:
                active[name] -= 1
            if active[name] == 0:
                x = next(a for a in args if torch.is_tensor(a))
                seen.append((name, x, out[0] if isinstance(out, tuple)
                             else out))
            return out
        return rec

    for n, fn in saved.items():
        setattr(L, n, wrap(n, fn))
    try:
        yield seen
    finally:
        for n, fn in saved.items():
            setattr(L, n, fn)


def probe_verify_rows(model, params, ecfg, k=VERIFY_K):
    """The row-invariance probe: from one cache state (4 requests after
    prefill, an eager engine), k+1 stepped decode steps (each token the
    previous step's argmax) against one (k+1)-token verify pass over the
    same tokens, as the engine runs it (`models.layers` splits the
    row-sensitive reductions), every recorded op's output compared row
    for row with `torch.equal`: every op must be equal, and a call that
    differs on equal inputs is named.  -> {op: {"differ", "calls"},
    "ops_that_break_it": [...]}."""
    import torch
    from repro_torch.core import kvcache as KV
    from repro_torch.launch.engine import DECODE, Engine, synthetic_workload

    engine = Engine(model, params, ecfg, device="cuda", graphs=False)
    reqs = synthetic_workload(ecfg.max_batch, vocab=model.cfg.vocab_size,
                              seed=1, prompt_range=(64, 64),
                              gen_range=(32, 32))
    for r in reqs:
        engine.submit(r)
    while any(r.state != DECODE for r in reqs):
        engine.step()
    live, tokens, positions, _ = engine._live_batch()
    snap = [{key: c[key].clone() for key in KV.QUANT_KEYS}
            for c in engine.caches]
    pos = torch.from_numpy(positions).to("cuda")

    def restore():
        for c, saved in zip(engine.caches, snap):
            for key in KV.QUANT_KEYS:
                c[key].copy_(saved[key])

    tok = torch.from_numpy(tokens).to("cuda")
    toks, steps = [tok], []
    for i in range(k + 1):
        with recorded_ops() as seen:
            logits, _ = model.decode_step(
                params, {"tokens": toks[-1], "index": pos + i},
                engine.caches)
        steps.append(seen)
        toks.append(logits[:, -1].argmax(-1)[:, None])
    restore()
    with recorded_ops() as ver:
        model.decode_step(params, {"tokens": torch.cat(toks[:k + 1], dim=1),
                                   "index": pos}, engine.caches)
    restore()
    if [c[0] for c in ver] != [c[0] for c in steps[0]]:
        raise AssertionError("probe: the verify pass and a decode step "
                             "call other ops")

    def same(j, part):
        return all(torch.equal(ver[j][part][:, i:i + 1], steps[i][j][part])
                   for i in range(k + 1))

    differ, first = {}, []
    for j, (name, _, _) in enumerate(ver):
        bad = not same(j, 2)
        differ.setdefault(name, [0, 0])
        differ[name][0] += bad
        differ[name][1] += 1
        if bad and same(j, 1) and len(first) < 8:
            # the op itself broke row invariance: equal inputs
            first.append(f"{name} over (..., {ver[j][1].shape[-1]}) rows "
                         f"(call {j})")
    out = {n: {"differ": d, "calls": c} for n, (d, c) in differ.items()}
    out["ops_that_break_it"] = first
    print(f"row-invariance probe: a {k + 1}-token verify pass against "
          f"{k + 1} decode steps, calls whose rows differ: "
          + ", ".join(f"{n} {d}/{c}" for n, (d, c) in differ.items())
          + "; calls that differ on equal inputs: "
          + (", ".join(first) or "none"))
    if any(d for d, _ in differ.values()):
        raise AssertionError(f"verify rows differ from decode steps: {out}")
    del engine
    return out


def _every_round_cycler(cfg, state, accepted, drafted):
    """A controller that hops to the next rung every round (whatever the
    acceptance), so every rung drafts."""
    import dataclasses
    nxt = (state.rung + 1) % len(cfg.ladder)
    return dataclasses.replace(state, rung=nxt,
                               switches=state.switches + 1), nxt


def profile_spec_steps(engine, label, seen):
    """One replay of each draft step (from position 0 on the scratch page:
    the run has ended, every table row is scratch) and of each verify
    step, profiled once a step name over phase 3j (`seen` holds the
    profiles already taken): device ms, unprofiled wall, launches; with
    this engine's graphs' pool bytes.  -> {step name: profile}."""
    e = engine.ecfg
    zeros = dict(positions=[0] * e.max_batch, i=0)
    fns = {}
    for r in engine.rungs:
        def draft(r=r):
            r.draft.load(**zeros)
            return r.draft.run()
        fns[r.draft.name] = draft
    for step in engine._verify.values():
        fns[step.name] = step.run
    out = {}
    for name, fn in fns.items():
        if name not in seen:
            seen[name] = profile_window(f"{label} {name}", fn,
                                        watch=("paged_decode",
                                               "dpa_fused_kernel"), timed=3)
        out[name] = dict(seen[name])
    for step in engine._steps:
        if step.name in out:
            out[step.name]["pool_bytes"] = step.stats["pool_bytes"]
    return out


def _spec_line(name, rep, plain, prof) -> str:
    def ms(p):
        b = p.get("busy_ms")
        return "not measured" if b is None else (
            f"{b:.3f} device ms in {p['unprofiled_wall_ms']:.2f} ms")
    steps = "; ".join(f"{k}: {ms(p)}, pool {p.get('pool_bytes', 0) / 1e6:.1f}"
                      " MB" for k, p in prof.items())
    return (f"spec {name}: acceptance {rep['acceptance_rate']:.4f}, "
            f"{rep['eff_tokens_per_round']:.3f} tokens a round over "
            f"{rep['spec_rounds']} rounds, {rep['tokens_per_s']:.2f} tok/s "
            f"(plain graphed {plain['tokens_per_s']:.2f}, "
            f"{rep['tokens_per_s'] / plain['tokens_per_s']:.2f}x); {steps}")


def spec_requests(cfg, cut=True, n=SPEC_FEW):
    """The first n of phase 3's requests, each cut to `SPEC_NEW` new
    tokens (the prefix of their greedy tokens) unless `cut` is off."""
    reqs = workload(cfg)[:n]
    for r in reqs:
        r.max_new = min(r.max_new, SPEC_NEW) if cut else r.max_new
    return reqs


def run_spec(cfg, ecfg, model, params, greedy_tokens, plain_rep):
    """Phase 3j: qwen3-4b at full width under its serving policy, graphed,
    speculative: the row-invariance probe; a self-draft at k = 4 (every
    draft accepted, phase 3a's greedy tokens for all 8 requests); on the
    first `SPEC_FEW` requests cut to `SPEC_NEW` new tokens
    (`spec_requests`; `SPEC_ONE` of them for all but the default
    ladder's run) a static w4a4_kv4_attn4 draft (their greedy
    tokens), the default adaptive ladder under the default controller and
    (the requests whole) under one that switches every round (the greedy
    tokens; every rung's attention format launched), and a sampled
    adaptive run twice on `SPEC_ONE` request (both drain, equal tokens).  Each run's acceptance, tokens a round, tokens/s
    against the plain graphed engine, one replay of each draft and verify
    step profiled (once a step) and the pools' bytes.  -> (reports,
    counts summed)."""
    from repro_torch.core.policy import get_policy
    from repro_torch.runtime import controller as CTRL
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.spec_decode import SpecConfig

    out = {"probe": probe_verify_rows(model, params, ecfg)}
    ladder = CTRL.ControllerConfig(CTRL.default_ladder(cfg.policy),
                                   k=VERIFY_K)
    runs = (("self-draft", dict(spec=SpecConfig(cfg.policy, VERIFY_K))),
            ("static w4a4_kv4_attn4",
             dict(spec=SpecConfig("w4a4_kv4_attn4", VERIFY_K))),
            ("adaptive", dict(adaptive=ladder)),
            ("adaptive, every-round switch",
             dict(adaptive=ladder, ctrl_step=_every_round_cycler)))
    counts, profiles = [], {}
    for name, kw in runs:
        # the switch-every-round run keeps its requests whole: it must
        # draft enough rounds to walk every rung
        reqs = (workload(cfg) if name == "self-draft" else spec_requests(
            cfg, cut=not name.startswith("adaptive, every"),
            n=SPEC_FEW if name == "adaptive" else SPEC_ONE))
        rep, n, engine = serve_once(f"{cfg.name} spec engine, {name}", cfg,
                                    model, params, ecfg, reqs, **kw)
        counts.append(n)
        differ = [r.rid for r in reqs
                  if r.out_tokens != greedy_tokens[r.rid][:r.max_new]]
        if differ:
            raise AssertionError(f"spec {name}: requests {differ} differ "
                                 "from the plain greedy tokens")
        if name == "self-draft" and rep["acceptance_rate"] != 1.0:
            raise AssertionError(f"self-draft acceptance "
                                 f"{rep['acceptance_rate']} != 1")
        fmts = {f: n[f"paged_decode_attention.{f}"]
                for f in ("fp4_e2m1", "fp8_e4m3", "fp16")}
        # every rung that drafted a round launched its attention format
        # (the switch-every-round run drafts on all three)
        used = {get_policy(r["policy"]).fmt_attn
                for r in rep.get("adaptive_rungs", ()) if r["rounds"]}
        if name.startswith("adaptive, every"):
            used = set(fmts)
        if not all(fmts[f] for f in used):
            raise AssertionError(f"spec {name}: a rung's attention format "
                                 f"never launched: rungs drafted in "
                                 f"{sorted(used)}, launches {fmts}")
        rep["paged_launches_by_format"] = fmts
        rep["step_profiles"] = profile_spec_steps(engine, f"spec {name}",
                                                  profiles)
        print(f"spec {name}: every request's tokens equal the plain greedy "
              f"engine's; paged decode launches by attention format {fmts}"
              + (f"; {rep['adaptive_switches']} rung switches, wall share "
                 + ", ".join(f"{r['policy']} {r['wall_share']:.3f}"
                             for r in rep["adaptive_rungs"])
                 if "adaptive_rungs" in rep else ""))
        print(_spec_line(name, rep, plain_rep, rep["step_profiles"]))
        out[name] = rep
        del engine
    sampled = []
    for i in range(2):
        name = f"sampled adaptive {i + 1}"
        reqs = spec_requests(cfg, n=SPEC_ONE)
        rep, n, engine = serve_once(
            f"{cfg.name} spec engine, {name}", cfg, model, params, ecfg,
            reqs, sampler=SamplerConfig(**SAMPLED), adaptive=ladder)
        counts.append(n)
        sampled.append([r.out_tokens for r in reqs])
        rep["step_profiles"] = profile_spec_steps(engine, f"spec {name}",
                                                  profiles)
        print(_spec_line(name, rep, plain_rep, rep["step_profiles"]))
        out[name] = rep
        del engine
    if sampled[0] != sampled[1]:
        raise AssertionError("sampled adaptive runs gave other tokens")
    print(f"spec sampled adaptive ({SAMPLED}): two runs drain and give "
          f"the same tokens for all {SPEC_ONE} requests; acceptance "
          f"{out['sampled adaptive 1']['acceptance_rate']:.4f}")
    return out, add_counts(*counts)


def run_front_end_adaptive(cfg):
    """`python -m repro_torch.launch.serve` with FRONT_END_ADAPTIVE (the
    adaptive ladder, greedy), as one `main` call on the card, counters
    zeroed just before and read just after (the run's launches and the
    captures' warm-up calls: one a draft rung, the verify step, the
    prefill chunk).  -> (report, counts)."""
    import io
    import torch
    from repro_torch.core.policy import get_policy
    from repro_torch.launch import serve
    from repro_torch.runtime.controller import default_ladder

    out = io.StringIO()
    zero_counts()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out):
        rep = serve.main(FRONT_END_ADAPTIVE)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    text = out.getvalue()
    print("front end: python -m repro_torch.launch.serve "
          + " ".join(FRONT_END_ADAPTIVE))
    print(text, end="")
    n_req = int(FRONT_END_ADAPTIVE[FRONT_END_ADAPTIVE.index("--requests")
                                   + 1])
    if "adaptive: 3-rung ladder" not in text or rep["n_requests"] != n_req:
        raise AssertionError(f"adaptive front end printed: {text}")
    ladder = [get_policy(p) for p in default_ladder(cfg.policy)]
    rounds = [r["rounds"] * r["k"] for r in rep["adaptive_rungs"]]
    # the warm-ups: each draft step once, the verify step once (k = 4),
    # the prefill chunk once
    warm = dict(rep, prefill_calls=rep["prefill_calls"] + 1,
                verify_steps=rep["verify_steps"] + 1)
    want = engine_counts(cfg, warm, [(p, n + 1) for p, n in
                                     zip(ladder, rounds)])
    check_counts("qwen3-4b adaptive front end", counts, want)
    print(f"adaptive front end: {wall:.1f} s for the call")
    rep["call_s"] = wall
    return rep, counts


def add_counts(*runs) -> dict:
    """The launch counts of several runs, summed per counter."""
    out = {}
    for counts in runs:
        for k, v in counts.items():
            out[k] = out.get(k, 0) + v
    return out


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


def check_path_attention(what, calls, plain, kernel=None, window=None,
                         causal=True, fmt="fp8_e4m3"):
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
    bytes).  A local attention path passes its `window`, a non-causal one
    (an encoder's, a cross-attention's: Sq may differ from Sk) `causal`
    False; `fmt` is the DPA route's attention format (its codes' dtype and
    flip bound)."""
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
            B, H, Sq, _ = qh.shape
            Sk = kh.shape[2]
            if codes is None or codes[0].shape != (B, H, Sq, Sk):
                codes = None                # free the old buffers first
                codes = [torch.zeros((B, H, Sq, Sk),
                                     dtype=FA.p_code_dtype(fmt),
                                     device=q.device) for _ in range(2)]
                mask = FA._mask(Sq, Sk, causal, window, q.device)
            for c in codes:
                c.zero_()
            again = kernel(qh, kh, vh, codes[0])
            if not torch.equal(again, got):
                raise AssertionError(f"{what}: layer {i}'s kernel output "
                                     "differs from the route's on the same "
                                     "inputs")
            want = plain(qh, kh, vh, codes[1]).float()
            err = (got.float() - want).abs()
            bad, n = _dpa_flash_misses(err, want, codes, vh, mask, fmt)
            live = H * int(mask.sum())
            flips.append(n)
            if n > DPA_FLASH_FLIP_BUDGET[fmt] * live:
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
              f"{DPA_FLASH_FLIP_BUDGET[fmt]:g} of each layer's live codes)")
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
    label = f"{cfg.name} prefill ({S} tokens)"
    prof = profile_window(label, lambda: step(params, tokens))
    path_roofline(label, prof, lambda: step(params, tokens),
                  (cfg, "prefill", S, 1), wall * 1e3)
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
    label = f"{cfg.name} scoring ({S} tokens)"
    prof = profile_window(label, lambda: loss_fn(params, batch))
    matched = path_roofline(label, prof, lambda: loss_fn(params, batch),
                            (cfg, "prefill", S, 1), wall * 1e3)
    check_linear_census(label, matched["work"], cfg, S)
    return counts, {"wall_s": wall, "tokens_per_s": S / wall, "loss": loss,
                    "loss_ref_attn": ref_loss, "loss_diff": loss - ref_loss,
                    "attn_max_abs_err_vs_plain": layer_err,
                    "attn_p_codes_flipped_per_layer": layer_flips,
                    "profile": prof}


# -----------------------------------------------------------------------------
# phase 3m: the presets the new formats unlock (paths L, M, N)
# -----------------------------------------------------------------------------

FUSED_PRESET = "fp4_dpa_fused"         # path L: E2M1 activations in the kernel
# path M: (policy, requests of phase 3's 8), each request cut to
# PAGED_PRESET_NEW new tokens
PAGED_PRESETS = (("kv8_attn_f32", 8), ("kv16_attn_f32", 4),
                 ("attn_fp16_dpa", 4))
PAGED_PRESET_NEW = 8
FLASH_PRESETS = ("attn_fp16_dpa", "attn_fp4_packed")   # path N


def run_fused_generate(cfg, params, *, n_prompts=2, prompt_len=32,
                       n_new=16):
    """Path L's static serving: `generate` under fp4_dpa_fused (packed-E2M1
    weights, activations quantized onto E2M1 in the fused kernel) over
    params built for the model (prepared again for the policy), eagerly
    and with the serve step as a CUDA graph: the same tokens, finite
    logits, and every projection of every model call on the split-K route
    with E2M1 activations (the counters by route and by activation
    format; a MoE model's experts through the grouped kernel).  ->
    (the graphed run's counts, report)."""
    import torch
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
    n_d, n_e = dense * cfg.n_layers * calls, experts * cfg.n_layers * calls
    want = {"dpa_matmul_fused": n_d, "dpa_matmul_fused.splitk": n_d,
            "dpa_matmul_fused.fp4_e2m1": n_d,
            "dpa_grouped_matmul_fused": n_e,
            "dpa_grouped_matmul_fused.splitk": n_e,
            "dpa_grouped_matmul_fused.fp4_e2m1": n_e}
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
                ((out >= 0) & (out < cfg.vocab_size)).all()):
            raise AssertionError(f"generate returned {tuple(out.shape)}")
        check_counts(f"{cfg.name} generate ({cfg.policy}, {mode})", counts,
                     want)
        st = generate.capture_stats
        timed = calls - 1 if st else calls
        step_wall = wall - (st["warmup_s"] + st["capture_s"] if st else 0.0)
        res[mode] = {"wall_s": wall, "model_calls": calls,
                     "ms_per_call": step_wall / timed * 1e3}
        print(f"generate ({mode}): {cfg.name} under {cfg.policy}, "
              f"{n_prompts} prompts x {prompt_len} tokens + {n_new} new in "
              f"{wall:.2f} s ({res[mode]['ms_per_call']:.1f} ms a model "
              "call" + (" replayed)" if st else ")"))
        outs[mode] = out.cpu()
    if not restore():
        raise AssertionError("non-finite logits")
    if not torch.equal(outs["eager"], outs["graphed"]):
        raise AssertionError(f"{cfg.name} {cfg.policy}: graphed generate "
                             "tokens differ from the eager run's")
    print(f"generate {cfg.name} {cfg.policy}: graphed tokens equal the "
          "eager run's; new tokens "
          f"{outs['graphed'][:, prompt_len:].tolist()}")
    return counts, {**res["graphed"], "eager": res["eager"],
                    "tokens_equal_eager": True}


def run_fused_scoring(cfg, params, S=4096):
    """Path L's long pass: the forward of `make_loss_fn` over one S-token
    sequence under fp4_dpa_fused with use_flash: every projection on the
    fused kernel's tiled route with E2M1 activations (the pre-pass
    `dpa_act_quant` writes them as E4M3 bytes), every layer's attention
    through the f32 flash kernel (f32 attention; its bf16 instance).  A
    warm-up, then a timed and counted call; the loss finite, near ln V and
    within SCORING_REF_TOL of the same call with use_flash off; the tiled
    route's operations equal the analytic census's.  -> (counts,
    report)."""
    import math
    import torch
    from repro_torch.distributed.step import make_loss_fn
    from repro_torch.kernels import counters
    from repro_torch.models import build_model
    model = build_model(cfg, device="cuda")
    params = model.prepare_params(params)
    loss_fn = make_loss_fn(model)
    batch = {"tokens": _prompt(cfg, S, 5), "labels": _prompt(cfg, S, 6)}
    loss_fn(params, batch)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    _, parts = loss_fn(params, batch)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    delta = counters.snapshot()
    counts = read_counts()
    n = per_call_projections(cfg)[0] * cfg.n_layers
    check_counts(f"{cfg.name} scoring ({cfg.policy}, use_flash)", counts,
                 {"flash_attention": cfg.n_layers, "dpa_matmul_fused": n,
                  "dpa_matmul_fused.tiled": n,
                  "dpa_matmul_fused.fp4_e2m1": n, "dpa_act_quant": n})
    check_linear_census(f"{cfg.name} scoring ({cfg.policy})", delta, cfg, S)
    _, ref_parts = make_loss_fn(build_model(
        cfg.replace(use_flash=False), device="cuda"))(params, batch)
    loss, ref_loss = float(parts["loss"]), float(ref_parts["loss"])
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(loss) and 0.5 * ln_v < loss < 1.5 * ln_v
            and abs(loss - ref_loss) <= SCORING_REF_TOL):
        raise AssertionError(f"{cfg.policy} scoring loss {loss} (use_flash "
                             f"off {ref_loss}, limit {SCORING_REF_TOL})")
    print(f"scoring: {cfg.name} {S} tokens under {cfg.policy}, loss "
          f"{loss:.6f} (use_flash off {ref_loss:.6f}, diff "
          f"{loss - ref_loss:.3g}) in {wall:.3f} s = {S / wall:.1f} "
          "tokens/s")
    label = f"{cfg.name} scoring ({S} tokens, {cfg.policy})"
    prof = profile_window(label, lambda: loss_fn(params, batch))
    path_roofline(label, prof, lambda: loss_fn(params, batch),
                  (cfg, "prefill", S, 1), wall * 1e3)
    return counts, {"wall_s": wall, "tokens_per_s": S / wall, "loss": loss,
                    "loss_ref_attn": ref_loss, "loss_diff": loss - ref_loss,
                    "profile": prof}


def run_flash_formats(cfg, params, S=4096):
    """Path N: the forward of `make_loss_fn` over one S-token sequence
    with use_flash (the cache-free pass: a prefill writes a quantized
    cache and attends its dequantized rows through the plain route, in
    the reference as here) under attn_fp16_dpa and attn_fp4_packed, on
    params built for the model: every layer's attention through the DPA
    flash kernel in fp16 or E2M1 attention after its pre-pass (two
    row-quantizer launches a layer: fp16 K/V codes by `quantize_rows`,
    packed E2M1 by `quantize_pack_rows`), the linears f32 (cuBLAS, as the
    reference computes them outside any kernel).  Per policy: a warm-up,
    then a timed and counted call; the loss finite and near ln V (its
    distance to use_flash off, where p is quantized under the row's global
    max, reported); every layer's attention held to the plain version by
    `check_path_attention` (its format's flip budget and each output's
    bound) and within the route's tol.  -> (counts summed, {policy:
    report})."""
    import math
    import torch
    from repro_torch.core import exec_plan
    from repro_torch.core.policy import get_policy
    from repro_torch.distributed.step import make_loss_fn
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import FLASH_BLOCK
    from repro_torch.models import build_model
    route_tol = exec_plan.route("flash_attn", "cuda_dpa_flash").tol
    out, total = {}, {}
    for name in FLASH_PRESETS:
        pcfg = cfg.replace(policy=name, use_flash=True)
        pol = get_policy(name)
        model = build_model(pcfg, device="cuda")
        p = model.prepare_params(params)
        loss_fn = make_loss_fn(model)
        batch = {"tokens": _prompt(pcfg, S, 5), "labels": _prompt(pcfg, S, 6)}
        loss_fn(p, batch)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.monotonic()
        _, parts = loss_fn(p, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = read_counts()
        prepass = ("quantize_pack_rows" if pol.fmt_kv == "fp4_e2m1"
                   else "quantize_rows")
        L = pcfg.n_layers
        check_counts(f"{pcfg.name} scoring ({name}, use_flash)", counts,
                     {"dpa_flash_attention": L,
                      "dpa_flash_attention.prepass": L, prepass: 2 * L})
        _, ref_parts = make_loss_fn(build_model(
            pcfg.replace(use_flash=False), device="cuda"))(p, batch)
        loss, ref_loss = float(parts["loss"]), float(ref_parts["loss"])
        ln_v = math.log(pcfg.vocab_size)
        if not (math.isfinite(loss) and 0.5 * ln_v < loss < 1.5 * ln_v):
            raise AssertionError(f"{name} scoring loss {loss} (ln V "
                                 f"{ln_v:.4f})")
        calls = []
        with recorded_attention(calls):
            loss_fn(p, batch)
        kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, bk=FLASH_BLOCK)
        err, flips = check_path_attention(
            f"scoring {name}", calls,
            lambda q, k, v, c, kw=kw: FA.dpa_flash_attention_ref(
                q, k, v, p_codes=c, **kw),
            kernel=lambda q, k, v, c, kw=kw: FA.dpa_flash_attention(
                q, k, v, p_codes=c, bq=FLASH_BLOCK, **kw), fmt=pol.fmt_attn)
        del calls
        if err > route_tol:
            raise AssertionError(f"{name}: a layer's attention is {err} off "
                                 f"the plain version (route tol {route_tol})")
        out[name] = {"wall_s": wall, "tokens_per_s": S / wall, "loss": loss,
                     "loss_ref_attn": ref_loss,
                     "loss_diff": loss - ref_loss,
                     "attn_max_abs_err_vs_plain": err,
                     "attn_p_codes_flipped_per_layer": flips}
        print(f"scoring: {pcfg.name} {S} tokens under {name}, loss "
              f"{loss:.6f} (use_flash off {ref_loss:.6f}, diff "
              f"{loss - ref_loss:.3g}) in {wall:.3f} s = {S / wall:.1f} "
              "tokens/s")
        if name == FLASH_PRESETS[0]:     # one route table: the fp16 pass
            label = f"{pcfg.name} scoring ({S} tokens, {name})"
            prof = profile_window(label, lambda: loss_fn(p, batch))
            path_roofline(label, prof, lambda: loss_fn(p, batch),
                          (pcfg, "prefill", S, 1), wall * 1e3)
            out[name]["profile"] = prof
        total = add_counts(total, counts)
        del model, p, loss_fn
    return total, out


def run_paged_presets(cfg, ecfg, params):
    """Path M: the engine at phase 3a's geometry on the model's weights
    (one build; each policy re-wraps them, `prepare_params`) under
    kv8_attn_f32 (phase 3's 8 requests), kv16_attn_f32 and attn_fp16_dpa
    (its first 4), each request cut to PAGED_PRESET_NEW new tokens,
    greedy, with its steps as CUDA graphs and, on the first request,
    eagerly: the graphed run's tokens equal the eager run's; every decode
    step's attention through
    the paged kernel in the policy's attention format over its cache codes
    (f32 over E4M3, f32 over fp16, fp16 over fp16: the counters by format,
    `engine_counts`), the linears f32 (no kernel); the first request
    replayed through the static path in the engine's prefill chunks
    (`teacher_forced`: the first token equal, at least half agreeing).
    -> (the graphed runs' counts summed, {policy: report})."""
    from repro_torch.models import build_model
    out, total = {}, {}
    for name, n_req in PAGED_PRESETS:
        pcfg = cfg.replace(policy=name)
        model = build_model(pcfg, device="cuda")
        p = model.prepare_params(params)
        restore = finite_steps(model)
        runs = {}
        for mode in ("eager", "graphed"):
            reqs = workload(pcfg)[:1 if mode == "eager" else n_req]
            for r in reqs:
                r.max_new = min(r.max_new, PAGED_PRESET_NEW)
            rep, counts, engine = serve_once(
                f"{pcfg.name} {name} engine ({mode})", pcfg, model, p, ecfg,
                reqs, graphs=mode == "graphed")
            runs[mode] = (rep, counts, reqs)
            del engine
        if not restore():
            raise AssertionError(f"{name}: non-finite logits")
        differ = [a.rid for a, b in zip(runs["eager"][2], runs["graphed"][2])
                  if a.out_tokens != b.out_tokens]
        if differ:
            raise AssertionError(f"{name}: graphed tokens differ from the "
                                 f"eager run's for requests {differ}")
        rep, counts, reqs = runs["graphed"]
        agreement = []
        for r in reqs[:1]:
            tf = teacher_forced(model, p, r, ecfg.s_max, ecfg.prefill_chunk)
            if not tf["first_token_agrees"] or 2 * tf["agree"] < tf["tokens"]:
                raise AssertionError(f"{name} request {r.rid}: teacher-forced"
                                     f" replay {tf}")
            agreement.append(dict(tf, rid=r.rid))
        out[name] = {k: rep[k] for k in (
            "n_requests", "gen_tokens", "tokens_per_s", "wall_s",
            "decode_steps", "prefill_calls", "p50_ttft_s", "p50_latency_s",
            "decode_route")}
        out[name].update(eager_tokens_per_s=runs["eager"][0]["tokens_per_s"],
                         tokens_equal_eager=True, agreement=agreement,
                         launches_by_format={
                             k: v for k, v in counts.items()
                             if k.startswith("paged_decode_attention.")
                             and v})
        print(f"{pcfg.name} under {name}: {n_req} requests x "
              f"{PAGED_PRESET_NEW} new tokens, graphed tokens equal eager; "
              f"{rep['tokens_per_s']:.2f} tok/s graphed "
              f"({runs['eager'][0]['tokens_per_s']:.2f} eager)")
        total = add_counts(total, counts)
        del model, p
    return total, out


def run_format_paths(qwen, granite, ecfg):
    """Paths L, M and N on fresh full-width models (`tools/formats_probe.py`
    runs them alone; `main` runs each on the weights of the phase that
    built them)."""
    import gc as _gc
    _, params = build(qwen)
    res = {"L generate": run_fused_generate(
               qwen.replace(policy=FUSED_PRESET), params)[1],
           "L scoring": run_fused_scoring(
               qwen.replace(policy=FUSED_PRESET, use_flash=True), params)[1],
           "N": run_flash_formats(qwen, params)[1],
           "M": run_paged_presets(qwen, ecfg, params)[1]}
    del params
    _gc.collect()
    _, params = build(granite)
    res["L granite generate"] = run_fused_generate(
        granite.replace(policy=FUSED_PRESET), params)[1]
    return res


# -----------------------------------------------------------------------------
# phase 3k: the recurrent families (paths G, H, I)
# -----------------------------------------------------------------------------

# a block's linears by kind (its mixers'; the MLP adds 3 when d_ff > 0,
# 2 for a GELU MLP): a decoder block's self- and cross-attention
MIXER_LINEARS = {"attn": 4, "attn_local": 4, "rg": 4, "mlstm": 7,
                 "slstm": 5, "enc": 4, "dec": 8}
RG_PROMPT = 4096                  # path H's prefill
RG_DECODE = 16                    # greedy steps after it


def linears_per_call(model, kinds=None) -> int:
    """Fused matmul launches one model call makes: every linear of every
    block of `kinds` (default the model's; an encoder-decoder's are its
    decoder's)."""
    cfg = model.cfg
    mlp = (3 if cfg.act == "silu" else 2) if cfg.d_ff > 0 else 0
    return sum(MIXER_LINEARS[k] + mlp
               for k in (model.kinds if kinds is None else kinds))


def check_dpa_flash_wide(gen, H=16, KV=1, S=RG_PROMPT, hd=256,
                         window=2048):
    """The DPA flash kernel's head-dim 256 instance against its plain
    version at path H's shape (one recurrentgemma-9b local attention
    layer: B 1, H 16, KV 1, S 4096, window 2048, causal, bf16, raw K/V on
    the fp4 grid: the pre-pass, then the kernel on packed codes; bq 64,
    bk 128), both sides writing every probability's E4M3 code: at most
    DPA_FLASH_MAX_FLIPS of the live codes may differ and every output is
    held to `_dpa_flash_misses`; then cache mode (fp8 codes and unpacked
    fp4) at S 1000 (bq 50, bk 125), window 300, which must equal raw mode
    bit for bit.  Timed at the first case, pre-pass included, beside its
    bound: the live (q, k) pairs of the band, x 2 products x 2 flop x hd
    x H, at the fp8 peak."""
    import torch
    from repro_torch.kernels import census as CS
    from repro_torch.core import kvcache as KVC
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import _fit_block
    out, worst, flips = None, 0.0, {}
    for name, S_, fmt_kv, cache, win in (
            ("raw fp4 window 2048", S, "fp4_e2m1", False, window),
            ("cache fp8 window 300", 1000, "fp8_e4m3", True, 300),
            ("cache fp4 window 300", 1000, "fp4_e2m1", True, 300)):
        q, k, v = _attn_inputs(gen, H, KV, S_, hd, torch.bfloat16)
        bq, bk = _fit_block(FA.max_bq(hd), S_), _fit_block(128, S_)
        kw = dict(fmt="fp8_e4m3", fmt_kv=fmt_kv, bq=bq, bk=bk, window=win)
        args = (q, k, v)
        if cache:
            kc, ks = KVC.quantize_kv(k, fmt=fmt_kv)
            vc, vs = KVC.quantize_kv(v, fmt=fmt_kv)
            args = (q, kc, vc, ks, vs)
            kw["kv_quant"] = True
        ref_kw = {x: y for x, y in kw.items() if x != "bq"}
        codes = [torch.zeros((1, H, S_, S_), dtype=torch.uint8,
                             device="cuda") for _ in range(2)]
        got = FA.dpa_flash_attention(*args, p_codes=codes[0], **kw)
        want = FA.dpa_flash_attention_ref(*args, p_codes=codes[1], **ref_kw)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        mask = FA._mask(S_, S_, True, win, "cuda")
        live = H * int(mask.sum())
        bad, n = _dpa_flash_misses(err, want.float(), codes, v, mask)
        del codes
        if not bool(torch.isfinite(got).all()) or bad or \
                n > DPA_FLASH_MAX_FLIPS * live:
            raise AssertionError(f"dpa_flash_attention hd {hd} {name}: "
                                 f"{bad} outputs off their bound (max err "
                                 f"{float(err.max())}), {n} of {live} p "
                                 "codes flipped")
        if cache:
            raw = FA.dpa_flash_attention(q, k, v, fmt="fp8_e4m3",
                                         fmt_kv=fmt_kv, bq=bq, bk=bk,
                                         window=win)
            if not torch.equal(raw, got):
                raise AssertionError(f"dpa_flash_attention hd {hd} {name}: "
                                     "cache rows gave other bits than raw "
                                     "K/V")
        worst = max(worst, float(err.max()))
        flips[name] = [n, live]
        print(f"dpa_flash_attention hd {hd} {name} H={H} KV={KV} S={S_} "
              f"bq={bq} bk={bk}: max_abs_err {float(err.max()):.3g}; {n} of "
              f"{live} live p codes flipped"
              + ("; == raw mode bit for bit" if cache else ""))
        if out is None:
            t = timings(lambda: FA.dpa_flash_attention(*args, **kw),
                        lambda: FA.dpa_flash_attention_ref(*args, **ref_kw))
            pairs = int(mask.sum())
            if pairs != CS.attn_pairs(S_, S_, True, win):
                raise AssertionError(f"the census counts "
                                     f"{CS.attn_pairs(S_, S_, True, win)} "
                                     f"band pairs, the mask {pairs}")
            work = CS.launch_work("dpa_flash_attention", B=1, H=H, KV=KV,
                                  sq=S_, sk=S_, hd=hd, q_bytes=2,
                                  kv_row_bytes=hd * 2, causal=True,
                                  window=win)
            t["bound_ms"], t["bound_by"] = bound(work)
            t["fp16_bound_ms"] = bound(work, peak_ops("fp16"))[0]
            t["band_pairs_per_head"] = pairs
            pre = lambda: (FA._prepass(k, fmt_kv),  # noqa: E731
                           FA._prepass(v, fmt_kv))
            t["prepass_ms"] = median_ms(pre)
            t["prepass_device_ms"] = device_ms(pre)
            print(f"dpa_flash_attention hd {hd} S={S_} window {win}: "
                  f"{fmt_times(t)} (pre-pass alone {t['prepass_ms']:.4f}, "
                  f"device {t['prepass_device_ms']}); bound_ms "
                  f"{t['bound_ms']:.5f} ({t['bound_by']}, fp8 peak; fp16 "
                  f"{t['fp16_bound_ms']:.5f}); {pairs} band pairs a head")
            out = t
    out["max_abs_err"] = worst
    out["flips"] = flips
    return out


# -----------------------------------------------------------------------------
# phase 2m: the kernels' remaining trans-precision formats (E2M1 and fp16
# activations in the fused matmul, fp16 and E2M1 attention and fp16 K/V in
# DPA flash; paged decode's in check_paged_formats / check_verify_fold)
# -----------------------------------------------------------------------------

NEW_ACT_FMTS = ("fp4_e2m1", "fp16")   # the fused kernels' new x formats
# DPA flash in the new attention formats: (name, H, KV, S, hd, fmt,
# fmt_kv, cache mode, packed cache, window, bq, bk), the first of each
# format timed: one qwen3-4b scoring layer (hd 128, S 4096), an hd 64
# layer at S 1000 (bk 125, whisper's), path H's local layer (hd 256,
# window 2048, bq 64), fp16 cache codes, and fp16 attention over packed
# E2M1 K/V (w16a16_kv4_attn16's mix)
DPA_NEW_CASES = (
    ("fp16 raw fp16", 32, 8, 4096, 128, "fp16", "fp16", False, False, None,
     128, 128),
    ("fp4 raw fp4", 32, 8, 4096, 128, "fp4_e2m1", "fp4_e2m1", False, False,
     None, 128, 128),
    ("fp16 raw fp16 hd 64", 16, 8, 1000, 64, "fp16", "fp16", False, False,
     None, 125, 125),
    ("fp4 raw fp4 hd 64", 16, 8, 1000, 64, "fp4_e2m1", "fp4_e2m1", False,
     False, None, 125, 125),
    ("fp16 cache fp16 hd 64", 16, 8, 1000, 64, "fp16", "fp16", True, False,
     None, 125, 125),
    ("fp16 raw fp16 hd 256 window 2048", 16, 1, 4096, 256, "fp16", "fp16",
     False, False, 2048, 64, 128),
    ("fp4 raw fp4 hd 256 window 2048", 16, 1, 4096, 256, "fp4_e2m1",
     "fp4_e2m1", False, False, 2048, 64, 128),
    ("fp16 cache fp16 hd 256 window 300", 16, 1, 1000, 256, "fp16", "fp16",
     True, False, 300, 50, 125),
    ("fp16 cache packed fp4", 32, 8, 1024, 128, "fp16", "fp4_e2m1", True,
     True, None, 128, 128))


def check_fused_formats(qwen, granite, gen):
    """The fused matmul with E2M1 and fp16 activations against its plain
    version at the fused route's pin, both routes: qwen3-4b's five
    projection shapes with packed-fp4 weights at M 8 and 32 (split-K) and
    4096 (tiled; the pre-pass's codes and scales equal its plain
    version's), E4M3 weights at the first shape, the rows of M = 8 and 1
    against an M = 64 call (`torch.equal`) at the shape with the largest
    split, and granite's expert shapes grouped (E 32, M 8 and 11, dropped
    rows exactly 0).  fp16 activations are held to the pin plus their
    blocks' sum order (`_block_sum_order`).  Timed: one qwen3-4b layer at
    M 8 and at M 4096 and one granite expert layer at M 8 per format,
    each beside its bound at the format's peak (fp16: 989 Top/s).  ->
    {fmt: {...}}."""
    import torch
    from repro_torch.kernels import census as CS
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels.ops import prep_grouped_weights, prep_weights
    projections = _dense_shapes(qwen)
    shapes = sorted(set(projections.values()))
    weights = {}
    for K, N in shapes:
        w = (torch.randn((K, N), generator=gen, device="cuda")
             * K ** -0.5).to(torch.bfloat16)
        weights[K, N] = (prep_weights(w, qwen.policy),
                         prep_weights(w, "fp8_dpa_fused"))
    E = granite.n_experts
    gshapes = sorted(set(_expert_shapes(granite).values()))
    gweights = {(K, N): prep_grouped_weights(
        torch.randn((E, K, N), generator=gen, device="cuda") * K ** -0.5,
        granite.policy) for K, N in gshapes}
    out = {}
    for fmt in NEW_ACT_FMTS:
        fp4 = dict(fmt_x=fmt, fmt_w="fp4_e2m1", pack_w=True)
        fp8 = dict(fmt_x=fmt, fmt_w="fp8_e4m3", pack_w=False)
        xb = DM.X_CODE_BYTES[fmt]
        edge = max(shapes, key=lambda kn: (
            DM.fused_plan(1, 8, *kn, xb=xb).split, kn))
        worst, timed, plans = 0.0, {}, {}
        for K, N in shapes:
            prep, prep8 = weights[K, N]
            for M in (8, 32, LARGE_M):
                x = torch.randn((M, K), generator=gen, device="cuda")
                if M == LARGE_M:
                    x[7, 128:256] = 0
                    x[9] *= 1e3
                x = x.to(torch.bfloat16)
                args = (x, prep["wq"], prep["sw"])
                plan = DM.fused_plan(1, M, K, N, xb=xb)
                route = "tiled" if M == LARGE_M else "splitk"
                if plan.route != route:
                    raise AssertionError(f"{fmt} M={M}: plan {plan}")
                plans[f"{K}x{N} M={M}"] = plan._asdict()
                label = f"dpa_matmul_fused {fmt} activations K={K} N={N} M={M}"
                err = _held(label, DM.dpa_matmul_fused(*args, **fp4),
                            DM.dpa_matmul_fused_ref(*args, **fp4),
                            _block_sum_order(*args, fp4))
                worst = max(worst, err)
                line = f"{label}: {_plan_str(plan)}; max_abs_err {err:.3g}"
                if M == LARGE_M:
                    codes, scales = DM.dpa_act_quant(x, fmt=fmt)
                    want_c, want_s = DM.dpa_act_quant_ref(x, fmt=fmt)
                    if not (torch.equal(codes, want_c)
                            and torch.equal(scales, want_s)):
                        raise AssertionError(f"dpa_act_quant {fmt} K={K}: "
                                             "codes or scales differ from "
                                             "the plain version")
                    line += "; pre-pass codes and scales exact"
                if M != 32:
                    t = timings(lambda: DM.dpa_matmul_fused(*args, **fp4),
                                lambda: DM.dpa_matmul_fused_ref(*args,
                                                                **fp4), 1)
                    t["bound_ms"], b_by = bound(CS.launch_work(
                        "dpa_matmul_fused", route, E=1, M=M, K=K, N=N,
                        x_bytes=2, fmt_w="fp4_e2m1", pack_w=True, fmt_x=fmt))
                    timed[(K, N, M)] = t
                    line += (f"; {fmt_times(t)} bound_ms "
                             f"{t['bound_ms']:.5f} ({b_by})")
                print(line)
            if (K, N) == shapes[0]:
                x = torch.randn((8, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                args = (x, prep8["wq"], prep8["sw"])
                err = _held(f"dpa_matmul_fused {fmt} activations, E4M3 "
                            f"weights K={K} N={N} M=8",
                            DM.dpa_matmul_fused(*args, **fp8),
                            DM.dpa_matmul_fused_ref(*args, **fp8),
                            _block_sum_order(*args, fp8))
                worst = max(worst, err)
                print(f"dpa_matmul_fused {fmt} activations, E4M3 weights "
                      f"K={K} N={N} M=8: max_abs_err {err:.3g}")
            if (K, N) == edge:
                x = torch.randn((64, K), generator=gen, device="cuda").to(
                    torch.bfloat16)
                rows_invariant(f"dpa_matmul_fused {fmt} activations K={K} "
                               f"N={N}", DM.dpa_matmul_fused, x,
                               (prep["wq"], prep["sw"]), fp4)
        gtimed = {}
        for K, N in gshapes:
            prep = gweights[K, N]
            for M, live in ((8, [4] * (E - 2) + [1, 0]),
                            (11, [11] * (E - 3) + [7, 3, 0])):
                x = _drop(torch.randn((E, M, K), generator=gen,
                                      device="cuda"), live).to(torch.bfloat16)
                args = (x, prep["wq"], prep["sw"])
                label = (f"dpa_grouped_matmul_fused {fmt} activations E={E} "
                         f"K={K} N={N} M={M}")
                got = GM.dpa_grouped_matmul_fused(*args, **fp4)
                err = _held(label, got,
                            GM.dpa_grouped_matmul_fused_ref(*args, **fp4),
                            _block_sum_order(*args, fp4))
                if any(bool((got[e, n:] != 0).any())
                       for e, n in enumerate(live)):
                    raise AssertionError(f"{label}: dropped rows not 0")
                worst = max(worst, err)
                plan = DM.fused_plan(E, M, K, N, xb=xb)
                line = (f"{label}: {_plan_str(plan)}; max_abs_err "
                        f"{err:.3g}; dropped rows 0")
                if M == 8:
                    t = timings(
                        lambda: GM.dpa_grouped_matmul_fused(*args, **fp4),
                        lambda: GM.dpa_grouped_matmul_fused_ref(*args,
                                                                **fp4), 1)
                    t["bound_ms"], b_by = bound(CS.launch_work(
                        "dpa_grouped_matmul_fused", "splitk", E=E, M=M, K=K,
                        N=N, x_bytes=2, fmt_w="fp4_e2m1", pack_w=True,
                        fmt_x=fmt))
                    gtimed[(K, N, M)] = t
                    line += (f"; {fmt_times(t)} bound_ms "
                             f"{t['bound_ms']:.5f} ({b_by})")
                print(line)
        res = {"max_abs_err": worst, "plans": plans,
               "decode_layer": _per_layer(timed, projections, 8),
               "tiled_layer": _per_layer(timed, projections, LARGE_M),
               "grouped_decode_layer": _per_layer(
                   gtimed, _expert_shapes(granite), 8)}
        out[fmt] = res
        print(f"dpa_matmul_fused {fmt} activations, one qwen3-4b layer "
              f"({len(projections)} calls): M=8 "
              f"{fmt_times(res['decode_layer'])}"
              f" bound {res['decode_layer']['bound_ms']:.5f} ms; M={LARGE_M} "
              f"{fmt_times(res['tiled_layer'])} bound "
              f"{res['tiled_layer']['bound_ms']:.4f} ms; granite expert "
              f"layer (E {E}, M=8) {fmt_times(res['grouped_decode_layer'])}"
              f" bound {res['grouped_decode_layer']['bound_ms']:.5f} ms")
    return out


def check_dpa_flash_formats(gen):
    """The DPA flash kernel in fp16 and E2M1 attention (`DPA_NEW_CASES`)
    against its plain version: both sides write every probability's code
    (fp16 values at fp16 attention, E4M3 bytes at E2M1), at most the
    format's `DPA_FLASH_FLIP_BUDGET` of the live codes may differ, and
    every output is
    held to its own bound (`_dpa_flash_misses`) and to the route's 0.075
    (the flash_attn route's tol); cache rows made from the same K/V give
    the raw mode's bits.  The first case of each format and head dim is
    timed beside its bound at the format's peak.  -> {case: {...}}."""
    import torch
    from repro_torch.core import kvcache as KVC
    from repro_torch.core import exec_plan
    from repro_torch.kernels import census as CS
    from repro_torch.kernels import flash_attention as FA
    route_tol = exec_plan.route("flash_attn", "cuda_dpa_flash").tol
    out, timed = {}, set()
    for (name, H, KV, S, hd, fmt, fmt_kv, cache, packed, window, bq,
         bk) in DPA_NEW_CASES:
        q, k, v = _attn_inputs(gen, H, KV, S, hd, torch.bfloat16)
        kw = dict(fmt=fmt, fmt_kv=fmt_kv, bq=bq, bk=bk, window=window)
        if cache:
            kc, ks = KVC.quantize_kv(k, fmt=fmt_kv, packed=packed)
            vc, vs = KVC.quantize_kv(v, fmt=fmt_kv, packed=packed)
            args = (q, kc, vc, ks, vs)
            kw.update(kv_quant=True, kv_packed=packed)
        else:
            args = (q, k, v)
        ref_kw = {x: y for x, y in kw.items() if x != "bq"}
        codes = [torch.zeros((1, H, S, S), dtype=FA.p_code_dtype(fmt),
                             device="cuda") for _ in range(2)]
        zero_counts()
        got = FA.dpa_flash_attention(*args, p_codes=codes[0], **kw)
        counts = read_counts()
        want = FA.dpa_flash_attention_ref(*args, p_codes=codes[1], **ref_kw)
        torch.cuda.synchronize()
        if counts["dpa_flash_attention"] != 1:
            raise AssertionError(f"dpa_flash_attention {name}: launches "
                                 f"{counts}")
        err = (got.float() - want.float()).abs()
        mask = FA._mask(S, S, True, window, "cuda")
        live = H * int(mask.sum())
        bad, flips = _dpa_flash_misses(err, want.float(), codes, v, mask,
                                       fmt)
        del codes
        if not bool(torch.isfinite(got).all()) or bad or \
                float(err.max()) > route_tol or \
                flips > DPA_FLASH_FLIP_BUDGET[fmt] * live:
            raise AssertionError(f"dpa_flash_attention {name} S={S} hd={hd}"
                                 f": {bad} outputs off their bound (max "
                                 f"err {float(err.max())}), {flips} of "
                                 f"{live} p codes flipped")
        line = ""
        if cache:
            raw = FA.dpa_flash_attention(q, k, v, fmt=fmt, fmt_kv=fmt_kv,
                                         bq=bq, bk=bk, window=window)
            if not torch.equal(raw, got):
                raise AssertionError(f"dpa_flash_attention {name}: cache "
                                     "rows gave other bits than raw K/V")
            line = "; == raw mode bit for bit"
        res = {"max_abs_err": float(err.max()), "flips": [flips, live]}
        if (fmt, hd) not in timed and not cache:
            timed.add((fmt, hd))
            res.update(timings(lambda: FA.dpa_flash_attention(*args, **kw),
                               lambda: FA.dpa_flash_attention_ref(*args,
                                                                  **ref_kw),
                               1))
            kv_row = hd * 2
            res["bound_ms"], res["bound_by"] = bound(CS.launch_work(
                "dpa_flash_attention", B=1, H=H, KV=KV, sq=S, sk=S, hd=hd,
                q_bytes=2, kv_row_bytes=kv_row, causal=True, window=window,
                fmt=fmt))
            line += (f"; {fmt_times(res)} (pre-pass included) bound_ms "
                     f"{res['bound_ms']:.5f} ({res['bound_by']}, {fmt} "
                     "peak)")
        out[name] = res
        print(f"dpa_flash_attention {name} H={H} KV={KV} S={S} hd={hd} "
              f"bq={bq} bk={bk}: max_abs_err {float(err.max()):.3g} (route "
              f"tol {route_tol}); {flips} of {live} live p codes flipped"
              + line)
        del q, k, v, args, got, want, err
    return out


def _peak_gb() -> float:
    import torch
    return torch.cuda.max_memory_allocated() / 1e9


def run_recurrent_generate(model, params, *, n_prompts=2, prompt_len=32,
                           n_new=16):
    """Paths G and I: `generate` at full width under w4a8_kv4_attn8,
    eagerly and with the serve step as a CUDA graph: the same tokens,
    every linear on the fused matmul's split-K route (the launch counters
    over each run), finite logits; then one serve step profiled eager and
    graphed (decode step device ms), and one replay held to its capture's
    counts.  -> (counts of the graphed run, report)."""
    import torch
    from repro_torch.distributed.step import make_serve_step
    from repro_torch.launch.graphs import Step, StepGraph
    from repro_torch.launch.serve import generate
    cfg = model.cfg
    restore = finite_steps(model)
    prompt = torch.randint(0, cfg.vocab_size, (n_prompts, prompt_len),
                           generator=torch.Generator().manual_seed(8))
    s_ctx = prompt_len + n_new
    calls = s_ctx - 1
    per_call = linears_per_call(model)
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
            raise AssertionError(f"generate returned {tuple(out.shape)}")
        check_counts(f"{cfg.name} generate ({cfg.policy}, {mode})", counts,
                     {"dpa_matmul_fused": per_call * calls,
                      "dpa_matmul_fused.splitk": per_call * calls})
        st = generate.capture_stats
        timed = calls - 1 if st else calls
        step_wall = wall - (st["warmup_s"] + st["capture_s"] if st else 0.0)
        res[mode] = {"wall_s": wall, "model_calls": calls,
                     "ms_per_call": step_wall / timed * 1e3,
                     "tokens_per_s": n_prompts * timed / step_wall,
                     "capture": st}
        print(f"generate ({mode}): {cfg.name} {n_prompts} prompts x "
              f"{prompt_len} tokens + {n_new} new in {wall:.2f} s ({calls} "
              f"model calls of {per_call} fused launches, "
              f"{res[mode]['ms_per_call']:.1f} ms each"
              + (" of the replayed ones" if st else "") + f", "
              f"{res[mode]['tokens_per_s']:.1f} tokens/s)")
        if st:
            print(_capture_line("serve step", st))
        outs[mode] = out.cpu()
        if mode == "graphed":
            res[mode]["counts"] = counts
    if not restore():
        raise AssertionError(f"{cfg.name}: non-finite logits")
    equal = torch.equal(outs["eager"], outs["graphed"])
    print(f"generate {cfg.name}: graphed tokens equal the eager run's: "
          f"{equal}; new tokens {outs['graphed'][:, prompt_len:].tolist()}")
    if not equal:
        raise AssertionError(f"{cfg.name}: graphed generate tokens "
                             f"{outs['graphed'].tolist()} differ from the "
                             f"eager run's {outs['eager'].tolist()}")
    caches = model.init_caches(n_prompts, s_ctx)
    serve_step = make_serve_step(model)

    def step(tokens, index):
        return serve_step(params, {"tokens": tokens, "index": index},
                          caches)[0]

    bufs = {"tokens": prompt[:, :1].to("cuda"),
            "index": torch.full((), s_ctx - 2, dtype=torch.int32,
                                device="cuda")}
    label = f"{cfg.name} serve step (B={n_prompts}, {cfg.policy})"
    cell = (cfg, "decode", prompt_len + n_new, n_prompts)
    eager = Step(step, bufs).run
    prof = {"eager": profile_window(f"{label}, eager", eager,
                                    watch=("dpa_fused_kernel",), timed=3)}
    path_roofline(f"{label}, eager", prof["eager"], eager, cell)
    graph = StepGraph(step, bufs, name="serve step")
    prof["graphed"] = check_replay(f"{label}, graphed", graph)
    path_roofline(f"{label}, graphed", prof["graphed"], graph.run, cell)
    del graph
    res["graphed"]["profile"] = prof
    res["graphed"]["tokens_equal_eager"] = equal
    res["graphed"]["fused_launches_per_call"] = per_call
    counts = res["graphed"].pop("counts")
    return counts, {**res["graphed"], "eager": res["eager"]}


def run_rg_prefill(cfg, params, S=RG_PROMPT, n_decode=RG_DECODE):
    """Path H: recurrentgemma-9b's S-token prefill with use_flash under
    w4a8_kv4_attn8 (`Model.prefill`): the 12 local attention layers
    through the DPA flash kernel at hd 256 with the window of 2048 (24
    pre-pass row-quantizer launches), every linear on the fused matmul's
    tiled route (with its pre-pass), the RG-LRU scan over S positions.
    Timed and counted; the window caches hold the last 2048 rows of each
    layer's K and V bit for bit; each layer's attention output within the
    route's tolerance (0.075) of its reference route (`torch_dpa_attn`,
    global-max p quantization) on the same inputs, and against the
    kernel's plain version (`check_path_attention`, p-code flips within
    DPA_FLASH_MAX_FLIPS).  The last logits against the same prefill with
    use_flash off are reported: 38 layers of fp8 activation codes carry
    the routes' differences, so, as path C's, they are only required to
    stay correlated (cosine >= 0.95).
    Then n_decode greedy steps from its caches (split-K route), the
    window sliding: each window cache shifts left by one row a step."""
    import torch
    from repro_torch.core import exec_plan
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import FLASH_BLOCK
    from repro_torch.models import build_model
    from repro_torch.models import decode_attn as D
    model = build_model(cfg, device="cuda")
    pol = get_policy(cfg.policy)
    W, hd = cfg.window, cfg.hd
    n_local = model.kinds.count("attn_local")
    per_call = linears_per_call(model)
    tokens = _prompt(cfg, S, 9)
    model.prefill(params, tokens)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.monotonic()
    logits, caches = model.prefill(params, tokens)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counts()
    check_counts(f"{cfg.name} prefill ({cfg.policy}, use_flash)", counts,
                 {"dpa_flash_attention": n_local,
                  "dpa_flash_attention.prepass": n_local,
                  "quantize_pack_rows": 2 * n_local,
                  "dpa_matmul_fused": per_call,
                  "dpa_matmul_fused.tiled": per_call,
                  "dpa_act_quant": per_call})
    ref, ref_caches = build_model(cfg.replace(use_flash=False),
                                  device="cuda").prefill(params, tokens)
    del ref_caches
    if logits.shape != (1, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    entry = exec_plan.resolve("flash_attn", pol, sq=S, skv=S,
                              use_flash=True, has_valid=False,
                              kv_on_grid=False)
    tol = entry.tol
    err = float((logits - ref).abs().max())
    scale = float(ref.abs().max())
    cos = float(torch.nn.functional.cosine_similarity(
        logits.reshape(1, -1), ref.reshape(1, -1)))
    tok, ref_tok = int(logits[0, -1].argmax()), int(ref[0, -1].argmax())
    print(f"prefill: last logits vs use_flash off: max |diff| {err:.4g} "
          f"(scale {scale:.4g}), cosine {cos:.6f}; greedy token {tok} "
          f"(use_flash off {ref_tok})")
    calls = []
    with recorded_attention(calls):
        model.prefill(params, tokens)
    local = [i for i, k in enumerate(model.kinds) if k == "attn_local"]
    for i, (q, k, v, out) in zip(local, calls):
        for key, rows in (("k", k), ("v", v)):
            if not torch.equal(caches[i][key], rows[:, -W:]):
                raise AssertionError(f"layer {i}: the window cache's {key} "
                                     "is not the prefill's last rows")
    # the route's own pin: each layer's flash output against its
    # reference route (global-max p quantization) on the same inputs
    route_errs = []
    for q, k, v, out in calls:
        mask = D.build_sdpa_mask(S, S, 0, True, W, device="cuda")
        want = D.dpa_attention(q, k, v, mask[None, None],
                               fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv,
                               scale=hd ** -0.5)
        route_errs.append(float((out.float() - want.float()).abs().max()))
        del want, mask
    print(f"prefill: {entry.name} vs {entry.reference} on each layer's "
          f"inputs: max |diff| per layer {[f'{e:.3g}' for e in route_errs]}"
          f" (route tolerance {tol})")
    if max(route_errs) > tol or cos < 0.95:
        raise AssertionError(f"prefill: layers off the route tolerance "
                             f"{route_errs}, or logits decorrelated from "
                             f"use_flash off (cosine {cos})")
    kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, bk=FLASH_BLOCK,
              window=W)
    layer_err, layer_flips = check_path_attention(
        "recurrentgemma prefill", calls,
        lambda q, k, v, c: FA.dpa_flash_attention_ref(q, k, v, p_codes=c,
                                                      **kw),
        kernel=lambda q, k, v, c: FA.dpa_flash_attention(
            q, k, v, p_codes=c, bq=FA.max_bq(hd), **kw), window=W)
    del calls
    label = f"{cfg.name} prefill ({S} tokens, use_flash)"
    prof = profile_window(label, lambda: model.prefill(params, tokens),
                          watch=("dpa_flash", "dpa_fused", "quantize_rows"))
    path_roofline(label, prof, lambda: model.prefill(params, tokens),
                  (cfg, "prefill", S, 1), wall * 1e3)
    # greedy decode from the prefill's caches; the window slides
    first_window = caches[local[0]]["k"].clone()
    zero_counts()
    nxt = logits[:, -1].argmax(-1)[:, None]
    new, t0 = [], time.monotonic()
    for t in range(n_decode):
        out, caches = model.decode_step(
            params, {"tokens": nxt, "index": S + t}, caches)
        nxt = out[:, -1].argmax(-1)[:, None]
        new.append(nxt)
    torch.cuda.synchronize()
    dec_wall = time.monotonic() - t0
    dec_counts = read_counts()
    check_counts(f"{cfg.name} decode after prefill", dec_counts,
                 {"dpa_matmul_fused": per_call * n_decode,
                  "dpa_matmul_fused.splitk": per_call * n_decode})
    slid = caches[local[0]]["k"]
    if not torch.equal(slid[:, :W - n_decode], first_window[:, n_decode:]):
        raise AssertionError("the window did not slide by one row a step")
    new = torch.cat(new, dim=1)
    if not bool(((new >= 0) & (new < cfg.vocab_size)).all()):
        raise AssertionError(f"decode tokens {new.tolist()}")
    print(f"prefill: {cfg.name} {S}-token prompt in {wall:.3f} s; "
          f"window caches = each layer's last {W} K/V rows; then "
          f"{n_decode} greedy steps (eager) in {dec_wall:.2f} s "
          f"({dec_wall / n_decode * 1e3:.1f} ms each), the window sliding: "
          f"tokens {new.tolist()}")
    return add_counts(counts, dec_counts), {
        "wall_s": wall, "max_abs_diff_vs_ref_attn": err, "logit_scale": scale,
        "cosine_vs_ref_attn": cos, "first_token": tok, "ref_token": ref_tok,
        "route_tol": tol, "route_max_abs_diff_per_layer": route_errs,
        "attn_max_abs_err_vs_plain": layer_err,
        "attn_p_codes_flipped_per_layer": layer_flips,
        "decode_steps": n_decode, "decode_wall_s": dec_wall,
        "decode_tokens": new.tolist(), "profile": prof}


def run_recurrent(gen):
    """Phase 3k: recurrentgemma-9b (paths G and H) and xlstm-1.3b (path
    I) at their published widths, seeded weights, w4a8_kv4_attn8; each
    model alone on the card, its peak memory printed.  -> (counts, report,
    hd 256 kernel timings)."""
    import torch
    from repro_torch.configs import get_config
    wide = check_dpa_flash_wide(gen)
    counts, report = [], {}
    for name in ("recurrentgemma-9b", "xlstm-1.3b"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(name).replace(policy="w4a8_kv4_attn8")
        model, params = build(cfg)
        if linears_per_call(model) != {"recurrentgemma-9b": 266,
                                       "xlstm-1.3b": 324}[name]:
            raise AssertionError(f"{name}: {linears_per_call(model)} "
                                 "linears a call")
        n, rep = run_recurrent_generate(model, params)
        counts.append(n)
        report[name] = {"generate": rep}
        if name == "recurrentgemma-9b":
            n, rep = run_rg_prefill(cfg.replace(use_flash=True), params)
            counts.append(n)
            report[name]["prefill"] = rep
        report[name]["peak_gb"] = _peak_gb()
        print(f"{name}: peak device memory {report[name]['peak_gb']:.2f} GB "
              "(max_memory_allocated)")
        del model, params
    gc.collect()
    torch.cuda.empty_cache()
    counts.append(run_recurrent_front_end())
    return add_counts(*counts), report, wide


RECURRENT_FRONT_END = ["--arch", "xlstm-1.3b", "--policy", "w4a8_kv4_attn8",
                       "--batch", "2", "--prompt-len", "32", "--gen", "16"]


def run_recurrent_front_end():
    """`python -m repro_torch.launch.serve` in its static mode on xlstm-1.3b
    at full width (its own model, seed 0): the report lines, a (2, 48)
    output, every linear of the 47 graphed model calls on the split-K
    route.  -> its counts."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.launch import serve
    zero_counts()
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main(RECURRENT_FRONT_END)
    text = buf.getvalue()
    print(text, end="")
    counts = read_counts()
    if tuple(out.shape) != (2, 48) or "kv-cache:" not in text or \
            "generated (2, 48)" not in text:
        raise AssertionError(f"front end: {tuple(out.shape)}, {text!r}")
    check_counts("xlstm-1.3b front end (static, graphed)", counts,
                 {"dpa_matmul_fused": 324 * 47,
                  "dpa_matmul_fused.splitk": 324 * 47})
    gc.collect()
    return counts



# -----------------------------------------------------------------------------
# phase 3l: the encoder-decoder and VLM families (paths J, K)
# -----------------------------------------------------------------------------

J_BATCH, J_PROMPT, J_DECODE = 2, 32, 16      # path J: whisper-medium
K_SEQ, K_DECODE = 4096, 8                    # path K: pixtral-12b


def stub_batch(cfg, B, S, frames=0, step=0):
    """One batch of the data pipeline (`SyntheticLM`, seed 0) with the
    config's stub front end, on the card: frames (B, frames, d) beside
    the tokens, or embeddings (B, S, d) in place of them."""
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    return make_pipeline(DataConfig(
        vocab_size=cfg.vocab_size, batch=B, seq=S, frontend=cfg.frontend,
        d_model=cfg.d_model, frames=frames), device="cuda").batch(step)


def grow_caches(caches, s_ctx):
    """A prefill's caches (each leaf (B, S, ...)) copied into zeroed
    caches of s_ctx positions: room for the decode steps after it."""
    import torch

    def grow(t):
        out = torch.zeros((t.shape[0], s_ctx) + t.shape[2:], dtype=t.dtype,
                          device=t.device)
        out[:, :t.shape[1]] = t
        return out
    return [{k: grow(v) for k, v in c.items()} for c in caches]


def _flash_blocks(q, k):
    """The flash routes' (bq, bk) for heads-first q, k
    (`kernels.registry`: blocks of up to FLASH_BLOCK cut to divide)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels.registry import FLASH_BLOCK, _fit_block
    return (_fit_block(min(FLASH_BLOCK, FA.max_bq(q.shape[-1])), q.shape[2]),
            _fit_block(FLASH_BLOCK, k.shape[2]))


def hold_dpa_layer(what, calls, pol, causal):
    """`check_path_attention` on recorded DPA flash calls, each run again
    at the route's blocks (bk is part of the numerics: 125 for 1,500
    keys)."""
    from repro_torch.kernels import flash_attention as FA
    kw = dict(fmt=pol.fmt_attn, fmt_kv=pol.fmt_kv, causal=causal)

    def plain(q, k, v, c):
        return FA.dpa_flash_attention_ref(q, k, v, p_codes=c,
                                          bk=_flash_blocks(q, k)[1], **kw)

    def kernel(q, k, v, c):
        bq, bk = _flash_blocks(q, k)
        return FA.dpa_flash_attention(q, k, v, p_codes=c, bq=bq, bk=bk, **kw)
    blocks = [_flash_blocks(*(t.transpose(1, 2) for t in c[:2]))
              for c in calls]
    err, flips = check_path_attention(what, calls, plain, kernel=kernel,
                                      causal=causal)
    print(f"{what}: (bq, bk) {sorted(set(blocks))}, Sq x Sk "
          f"{sorted({(c[0].shape[1], c[1].shape[1]) for c in calls})}")
    return {"max_abs_err": err, "p_codes_flipped": flips,
            "blocks": sorted(set(blocks))}


def hold_tiled_layer(what, lins):
    """Linears [(name, prepared params, x (M, K))] through the fused
    matmul's tiled route, at M and at the route's padded M (a multiple of
    128), against the plain version at the fused route's pin
    (`hold_linears`)."""
    import torch
    calls = []
    for name, lin, x in lins:
        M, K = x.shape
        for pad in sorted({M, -(-M // 128) * 128}):
            xp = torch.zeros((pad, K), dtype=x.dtype, device=x.device)
            xp[:M] = x
            calls.append((xp, lin["wq"], lin["sw"], FP4_FUSED))
    return hold_linears(what, calls, {"tiled": len(calls)})


@contextlib.contextmanager
def recorded_linears(calls, limit):
    """Inside, the first `limit` fused-matmul calls append their (x, wq,
    sw, keywords) as the model's linears hand them to the wrapper
    (`kernels.ops.dpa_matmul_fused_pipeline`: M already padded), so the
    first calls of a pass are its layer 0's."""
    from repro_torch.kernels import dpa_matmul as DM
    inner = DM.dpa_matmul_fused

    def record(x, wq, sw, **kw):
        if len(calls) < limit:
            calls.append((x, wq, sw, kw))
        return inner(x, wq, sw, **kw)

    # the wrapper counts on the function its module's name holds (now
    # `record`): one attribute dict, so its launch counters stay its own
    record.__dict__ = inner.__dict__
    DM.dpa_matmul_fused = record
    try:
        yield
    finally:
        DM.dpa_matmul_fused = inner


def hold_linears(what, calls, want):
    """Recorded fused-matmul calls (`recorded_linears`) run again through
    the kernel on their own operands and held to the plain version at the
    fused route's pin; `want` {route: n} is how many of them each route
    must take (`fused_plan` of the call's shape).  -> max |diff|."""
    from repro_torch.kernels import dpa_matmul as DM
    routes, worst, shapes = {}, 0.0, []
    for x, wq, sw, kw in calls:
        (M, K), N = x.shape, sw.shape[-1]
        # the launch-plan knobs the call took (None: the automatic plan)
        knobs = {k: v for k, v in kw.items() if k in ("bn", "split")}
        kw = {k: v for k, v in kw.items() if k not in knobs}
        plan = DM.fused_plan(1, M, K, N, **knobs)
        routes[plan.route] = routes.get(plan.route, 0) + 1
        worst = max(worst, _held(
            f"{what} M={M} K={K} N={N} {_plan_str(plan)}",
            DM.dpa_matmul_fused(x, wq, sw, **kw, **knobs),
            DM.dpa_matmul_fused_ref(x, wq, sw, **kw)))
        shapes.append(f"{M}x{K}x{N} {plan.route}"
                      + (f" split {plan.split}" if plan.route == "splitk"
                         else ""))
    if routes != want:
        raise AssertionError(f"{what}: routes {routes}, want {want}")
    print(f"{what}: {len(calls)} linears (M x K x N: {', '.join(shapes)}) "
          f"within the fused route's pin (max |diff| {worst:.3g})")
    return worst


def _timed(fn):
    """(result, synchronized wall seconds) of one call."""
    import torch
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, time.monotonic() - t0


def _cosine(a, b) -> float:
    import torch
    return float(torch.nn.functional.cosine_similarity(
        a.reshape(1, -1).float(), b.reshape(1, -1).float()))


def run_encdec(name="whisper-medium"):
    """Path J: whisper-medium at its published widths, seeded weights,
    w4a8_kv4_attn8 with use_flash, B 2 x 1,500 stub frames and a 32-token
    decoder prompt from the data pipeline's stub batch.  `encode` (the
    encoder's non-causal self-attention through the DPA flash kernel at
    hd 64, Sq = Sk = 1,500, bq = bk = 125, after its K/V pre-pass; every
    linear tiled at M = 3,000), `prefill` (the encoder again; the
    decoder's self-attention over its quantized cache on the plain
    route, cross-attention Sq 32 x Sk 1,500 through the DPA flash kernel,
    the decoder's linears on the split-K route, the cross K/V on the
    tiled route), then `J_DECODE` greedy `decode_step`s from the prefill's
    caches grown to 64 positions (cross K/V projected from `enc_out`
    at every step: tiled), each timed and counted.  The prompt stepped
    through decode_step from empty caches must land near the prefill's
    last logits (cosine >= 0.95).  Encoder layer 0's and decoder layer
    0's flash calls held to the plain version (`hold_dpa_layer`), encoder
    layer 0's linears at M = 3,000 (`hold_tiled_layer`), decoder layer
    0's linears in one decode step (`hold_linears`: eight split-K at M
    2, the cross K/V tiled).  Then the
    encoder under the model's own fp8_dpa (fake-quant linears, f32
    attention: the f32 flash kernel's bf16 instance, non-causal, hd 64,
    bq = bk = 125), counted, and its layer 0 held within one bf16 ulp."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.configs.whisper_medium import N_AUDIO_CTX
    from repro_torch.core.linear import apply_linear
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    cfg = get_config(name).replace(policy="w4a8_kv4_attn8", use_flash=True)
    pol = get_policy(cfg.policy)
    model, params = build(cfg)
    B, S, Se, n_dec = J_BATCH, J_PROMPT, N_AUDIO_CTX, J_DECODE
    n_enc, n_dl = len(model.enc_kinds), cfg.n_layers
    batch = stub_batch(cfg, B, S, frames=Se)
    enc_lin = linears_per_call(model, model.enc_kinds)
    dec_lin = linears_per_call(model)
    if (enc_lin, dec_lin) != (144, 240):
        raise AssertionError(f"{name}: {enc_lin} / {dec_lin} linears a call")
    enc_want = {"dpa_flash_attention": n_enc,
                "dpa_flash_attention.prepass": n_enc,
                "quantize_pack_rows": 2 * n_enc,
                "dpa_matmul_fused": enc_lin, "dpa_matmul_fused.tiled": enc_lin,
                "dpa_act_quant": enc_lin}
    rep, counts = {}, []

    model.encode(params, batch["frames"])
    zero_counts()
    enc_out, wall = _timed(lambda: model.encode(params, batch["frames"]))
    n = read_counts()
    check_counts(f"{name} encode ({cfg.policy}, use_flash)", n, enc_want)
    counts.append(n)
    if enc_out.shape != (B, Se, cfg.d_model) or not bool(
            torch.isfinite(enc_out).all()):
        raise AssertionError(f"encode {tuple(enc_out.shape)}")
    rep["encode"] = {"wall_s": wall, "frames_per_s": B * Se / wall}

    model.prefill(params, batch)
    zero_counts()
    (logits, caches), wall = _timed(lambda: model.prefill(params, batch))
    n = read_counts()
    cross_tiled = 2 * n_dl
    check_counts(f"{name} prefill ({cfg.policy}, use_flash)", n, {
        "dpa_flash_attention": n_enc + n_dl,
        "dpa_flash_attention.prepass": n_enc + n_dl,
        "quantize_pack_rows": 2 * (n_enc + n_dl),
        "dpa_matmul_fused": enc_lin + dec_lin,
        "dpa_matmul_fused.tiled": enc_lin + cross_tiled,
        "dpa_matmul_fused.splitk": dec_lin - cross_tiled,
        "dpa_act_quant": enc_lin + cross_tiled})
    counts.append(n)
    if logits.shape != (B, 1, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    rep["prefill"] = {"wall_s": wall, "tokens_per_s": B * S / wall}

    caches = grow_caches(caches, S + n_dec)
    nxt = logits[:, -1].argmax(-1)[:, None]
    new = [nxt]
    zero_counts()
    t0 = time.monotonic()
    for t in range(n_dec):
        out, caches = model.decode_step(
            params, {"tokens": nxt, "index": S + t, "enc_out": enc_out},
            caches)
        nxt = out[:, -1].argmax(-1)[:, None]
        new.append(nxt)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = read_counts()
    check_counts(f"{name} decode ({cfg.policy})", n, {
        "dpa_matmul_fused": dec_lin * n_dec,
        "dpa_matmul_fused.tiled": cross_tiled * n_dec,
        "dpa_matmul_fused.splitk": (dec_lin - cross_tiled) * n_dec,
        "dpa_act_quant": cross_tiled * n_dec})
    counts.append(n)
    new = torch.cat(new, dim=1)
    if not bool(((new >= 0) & (new < cfg.vocab_size)).all()) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"decode tokens {new.tolist()}")
    rep["decode"] = {"steps": n_dec, "wall_s": wall,
                     "ms_per_step": wall / n_dec * 1e3,
                     "tokens_per_s": B * n_dec / wall,
                     "tokens": new.tolist()}

    # the prompt through decode_step from empty caches (teacher-forced)
    fresh = model.init_caches(B, S + n_dec)
    for t in range(S):
        step_logits, fresh = model.decode_step(
            params, {"tokens": batch["tokens"][:, t:t + 1], "index": t,
                     "enc_out": enc_out}, fresh)
    cos = _cosine(step_logits[:, -1], logits[:, -1])
    same = bool(torch.equal(step_logits[:, -1].argmax(-1),
                            logits[:, -1].argmax(-1)))
    print(f"{name}: the prompt stepped through decode_step vs prefill: "
          f"last logits cosine {cos:.6f}, greedy tokens equal {same}")
    if cos < 0.95:
        raise AssertionError(f"stepped prompt vs prefill: cosine {cos}")
    rep["stepped_vs_prefill"] = {"cosine": cos, "greedy_equal": same}
    del fresh

    # encoder layer 0's flash call and its linears on their own inputs
    # (norm1 of the frames for the projections, the attention's output
    # for wo, norm2 of the residual for wu, gelu of wu's for wd), and
    # decoder layer 0's cross-attention, against their plain versions
    calls = []
    with recorded_attention(calls):
        model.encode(params, batch["frames"])
    rep["encoder_attention"] = hold_dpa_layer(
        f"{name} encoder self-attention (w4a8)", calls[:1], pol, False)
    lp = params["enc_layers"][0]
    x0 = batch["frames"].to(model.dtype)
    a = calls[0][3].reshape(B, Se, -1)
    del calls
    h = L.apply_norm(lp["norm1"], x0, eps=cfg.norm_eps)
    h2 = L.apply_norm(lp["norm2"], x0 + apply_linear(lp["attn"]["wo"], a, pol),
                      eps=cfg.norm_eps)
    u = L.gelu(apply_linear(lp["mlp"]["wu"], h2, pol).float()).to(
        model.dtype)
    rows = (lambda t: t.reshape(B * Se, -1).contiguous())
    rep["tiled_max_abs_err"] = hold_tiled_layer(
        f"{name} encoder layer 0",
        [(f"{m}.{w}", lp[m][w], rows(x)) for m, w, x in (
            ("attn", "wq", h), ("attn", "wk", h), ("attn", "wv", h),
            ("attn", "wo", a), ("mlp", "wu", h2), ("mlp", "wd", u))])
    del h, a, h2, u
    calls = []
    with recorded_attention(calls):
        model.prefill(params, batch)
    cross = [c for c in calls if c[1].shape[1] == Se and c[0].shape[1] == S]
    del calls
    rep["cross_attention"] = hold_dpa_layer(
        f"{name} cross-attention (w4a8)", cross[:1], pol, False)
    del cross
    # decoder layer 0's linears in one decode step: self-attention, the
    # cross K/V from enc_out (tiled, M 3,000 padded to 3,072), cross wq
    # and wo, the GELU MLP (split-K at M 2 padded to 8)
    lins = []
    with recorded_linears(lins, 10):
        model.decode_step(params, {"tokens": nxt, "index": S + n_dec - 1,
                                   "enc_out": enc_out}, caches)
    rep["decoder_linears_max_abs_err"] = hold_linears(
        f"{name} decoder layer 0, one decode step", lins,
        {"splitk": 8, "tiled": 2})
    del lins
    def encode():
        return model.encode(params, batch["frames"])

    def step():
        return model.decode_step(params, {"tokens": nxt,
                                          "index": S + n_dec - 1,
                                          "enc_out": enc_out}, caches)

    labels = (f"{name} encode (B {B} x {Se} frames)",
              f"{name} decode step (B {B}, eager)")
    rep["profile"] = {
        "encode": profile_window(labels[0], encode,
                                 watch=("dpa_flash", "fused_tiled",
                                        "act_quant", "quantize_rows")),
        "decode_step": profile_window(labels[1], step,
                                      watch=("dpa_fused", "fused_tiled"),
                                      timed=3)}
    path_roofline(labels[0], rep["profile"]["encode"], encode)
    path_roofline(labels[1], rep["profile"]["decode_step"], step,
                  (cfg, "decode", S + n_dec, B))
    # the analytic census's prefill: the encoder and the decoder prompt
    ROOFLINE.append({"path": f"{name} prefill (B {B} x {S} tokens)",
                     "cell": cell_report(f"{name} prefill", cfg, "prefill",
                                         S, B,
                                         rep["prefill"]["wall_s"] * 1e3)})

    # the encoder under the model's own policy: f32 attention
    cfg8 = cfg.replace(policy="fp8_dpa")
    model8 = build_model(cfg8, device="cuda")
    model8.encode(params, batch["frames"])
    zero_counts()
    enc8, wall = _timed(lambda: model8.encode(params, batch["frames"]))
    n = read_counts()
    check_counts(f"{name} encode (fp8_dpa, use_flash)", n,
                 {"flash_attention": n_enc})
    counts.append(n)
    calls = []
    with recorded_attention(calls):
        model8.encode(params, batch["frames"])
    err, _ = check_path_attention(
        f"{name} encoder self-attention (fp8_dpa, f32 flash)", calls[:1],
        lambda q, k, v: FA.flash_attention_ref(q, k, v, causal=False))
    del calls
    rep["encode_fp8_dpa"] = {
        "wall_s": wall, "frames_per_s": B * Se / wall,
        "attn_max_abs_err_vs_plain": err,
        "cosine_vs_w4a8": _cosine(enc8, enc_out),
        "profile": path_roofline(
            f"{name} encode (fp8_dpa)",
            profile_window(f"{name} encode (fp8_dpa)",
                           lambda: model8.encode(params, batch["frames"]),
                           watch=("flash",)),
            lambda: model8.encode(params, batch["frames"]))}
    print(f"{name}: encode {rep['encode']['wall_s'] * 1e3:.1f} ms "
          f"({rep['encode']['frames_per_s']:.0f} frames/s), prefill "
          f"{rep['prefill']['wall_s'] * 1e3:.1f} ms, {n_dec} greedy steps "
          f"{rep['decode']['ms_per_step']:.1f} ms each "
          f"({rep['decode']['tokens_per_s']:.1f} tokens/s); fp8_dpa encode "
          f"{wall * 1e3:.1f} ms; new tokens {new.tolist()}")
    del model, model8, params, caches, enc_out, enc8
    return add_counts(*counts), rep


def run_vlm(name="pixtral-12b"):
    """Path K: pixtral-12b at its published widths, seeded weights,
    w4a8_kv4_attn8 with use_flash, on the data pipeline's stub batch of
    B 1 x 4,096 embeddings.  A scoring `train_logits` (every linear
    tiled; causal DPA flash at hd 128 after its K/V pre-pass), then
    `prefill` of the same embeddings (tiled linears; attention over the
    quantized cache on the plain route) and `K_DECODE` greedy token
    `decode_step`s (split-K), each timed and counted.  The prefill's last
    logits near the scoring pass's (cosine >= 0.95); layer 0's flash call
    and seven linears of the scoring pass (tiled, M 4,096) and of one
    decode step (split-K, M 1) held to the plain version."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import get_policy
    cfg = get_config(name).replace(policy="w4a8_kv4_attn8", use_flash=True)
    pol = get_policy(cfg.policy)
    model, params = build(cfg)
    L, S, n_dec = cfg.n_layers, K_SEQ, K_DECODE
    lin = linears_per_call(model)
    if lin != 280:
        raise AssertionError(f"{name}: {lin} linears a call")
    batch = stub_batch(cfg, 1, S)
    emb = {"embeddings": batch["embeddings"]}
    rep, counts = {}, []

    model.train_logits(params, emb)
    zero_counts()
    (logits, _), wall = _timed(lambda: model.train_logits(params, emb))
    n = read_counts()
    check_counts(f"{name} scoring ({cfg.policy}, use_flash)", n, {
        "dpa_flash_attention": L, "dpa_flash_attention.prepass": L,
        "quantize_pack_rows": 2 * L, "dpa_matmul_fused": lin,
        "dpa_matmul_fused.tiled": lin, "dpa_act_quant": lin})
    counts.append(n)
    if logits.shape != (1, S, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"scoring logits {tuple(logits.shape)}")
    last = logits[:, -1].clone()
    del logits
    rep["scoring"] = {"wall_s": wall, "tokens_per_s": S / wall}
    calls, lins = [], []
    with recorded_attention(calls), recorded_linears(lins, 7):
        model.train_logits(params, emb)
    rep["attention"] = hold_dpa_layer(f"{name} scoring attention (w4a8)",
                                      calls[:1], pol, True)
    del calls
    rep["tiled_max_abs_err"] = hold_linears(
        f"{name} layer 0, scoring pass", lins, {"tiled": 7})
    del lins
    label = f"{name} scoring ({S} embeddings)"
    prof = profile_window(
        label, lambda: model.train_logits(params, emb),
        watch=("dpa_flash", "fused_tiled", "act_quant", "quantize_rows"))
    rep["scoring"]["profile"] = prof
    matched = path_roofline(label, prof,
                            lambda: model.train_logits(params, emb),
                            (cfg, "prefill", S, 1),
                            rep["scoring"]["wall_s"] * 1e3)
    check_linear_census(label, matched["work"], cfg, S)

    zero_counts()
    (first, caches), wall = _timed(lambda: model.prefill(params, emb))
    n = read_counts()
    check_counts(f"{name} prefill ({cfg.policy})", n, {
        "dpa_matmul_fused": lin, "dpa_matmul_fused.tiled": lin,
        "dpa_act_quant": lin})
    counts.append(n)
    cos = _cosine(first[:, -1], last)
    print(f"{name}: prefill's last logits vs the scoring pass's: cosine "
          f"{cos:.6f}")
    if first.shape != (1, 1, cfg.vocab_size) or cos < 0.95:
        raise AssertionError(f"prefill logits {tuple(first.shape)}, cosine "
                             f"{cos} to the scoring pass's")
    rep["prefill"] = {"wall_s": wall, "tokens_per_s": S / wall,
                      "cosine_vs_scoring": cos}
    caches = grow_caches(caches, S + n_dec)
    nxt = first[:, -1].argmax(-1)[:, None]
    new = [nxt]
    zero_counts()
    t0 = time.monotonic()
    for t in range(n_dec):
        out, caches = model.decode_step(params, {"tokens": nxt,
                                                 "index": S + t}, caches)
        nxt = out[:, -1].argmax(-1)[:, None]
        new.append(nxt)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    n = read_counts()
    check_counts(f"{name} decode ({cfg.policy})", n, {
        "dpa_matmul_fused": lin * n_dec,
        "dpa_matmul_fused.splitk": lin * n_dec})
    counts.append(n)
    new = torch.cat(new, dim=1)
    if not bool(((new >= 0) & (new < cfg.vocab_size)).all()) or not bool(
            torch.isfinite(out).all()):
        raise AssertionError(f"decode tokens {new.tolist()}")
    lins = []
    with recorded_linears(lins, 7):
        model.decode_step(params, {"tokens": nxt, "index": S + n_dec - 1},
                          caches)
    rep["splitk_max_abs_err"] = hold_linears(
        f"{name} layer 0, one decode step", lins, {"splitk": 7})
    del lins
    label = f"{name} decode step (B 1, eager)"

    def step():
        return model.decode_step(params, {"tokens": nxt,
                                          "index": S + n_dec - 1}, caches)

    rep["decode"] = {"steps": n_dec, "wall_s": wall,
                     "ms_per_step": wall / n_dec * 1e3,
                     "tokens_per_s": n_dec / wall, "tokens": new.tolist(),
                     "profile": profile_window(label, step,
                                               watch=("dpa_fused",), timed=3)}
    path_roofline(label, rep["decode"]["profile"], step,
                  (cfg, "decode", S + n_dec, 1))
    print(f"{name}: scoring {rep['scoring']['wall_s']:.3f} s "
          f"({rep['scoring']['tokens_per_s']:.1f} tokens/s), prefill "
          f"{rep['prefill']['wall_s']:.3f} s, {n_dec} greedy steps "
          f"{rep['decode']['ms_per_step']:.1f} ms each; new tokens "
          f"{new.tolist()}")
    del model, params, caches
    return add_counts(*counts), rep


def run_families():
    """Phase 3l: paths J and K, each model alone on the card, its peak
    memory printed.  -> (counts, report)."""
    import torch
    counts, report = [], {}
    for name, run in (("whisper-medium", run_encdec),
                      ("pixtral-12b", run_vlm)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"{name}: {torch.cuda.memory_allocated() / 1e9:.2f} GB on "
              "the card before the model")
        t0 = time.monotonic()
        n, rep = run(name)
        gc.collect()
        rep["peak_gb"] = _peak_gb()
        rep["seconds"] = time.monotonic() - t0
        print(f"{name}: peak device memory {rep['peak_gb']:.2f} GB "
              f"(max_memory_allocated); path {rep['seconds']:.1f} s")
        counts.append(n)
        report[name] = rep
    gc.collect()
    torch.cuda.empty_cache()
    return add_counts(*counts), report


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

# -----------------------------------------------------------------------------
# phase 5: training
# -----------------------------------------------------------------------------

TRAIN_ARCHS = ("qwen3-4b", "llama3.2-3b", "granite-moe-1b-a400m")
TRAIN_POLICIES = ("fp8_dpa", "fp32")
# card against the CPU after one train step: cuBLAS sums in another order
# than the CPU's fixed-order products, so the loss is held at rtol
# TRAIN_CPU_RTOL and every gradient and param leaf at relative norm
# TRAIN_CPU_LEAF.  Under fp8_dpa such a sum can also cross a rounding
# boundary of the E4M3 grid, and the STE operand then moves by a whole
# E4M3 step (1/8 to 1/16 of its value).  `ste_operands` records each
# quantizing call's codes, scales and operand on both devices; where any
# operand differs, the CPU step is recomputed from the card's own
# operands and held to TRAIN_CPU_LEAF, and where a code differs (a
# flip, not a scale's last bit) the CPU's own step is then held to
# TRAIN_FLIP_LEAF (the pin the CPU tests hold fp8_dpa train steps to
# against the reference)
TRAIN_CPU_RTOL = 1e-4
TRAIN_CPU_LEAF = 1e-3
TRAIN_FLIP_LEAF = 1e-2
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 3
TRAIN_LR, TRAIN_WARMUP = 1e-3, 2
REPLAY_LAYERS, REPLAY_STEPS, REPLAY_EVERY, REPLAY_FAIL_AT = 4, 6, 3, 4
# kernel families of a train step's profile (cuBLAS GEMMs, dtype casts
# and copies, the index backward's sorted accumulate, reductions, softmax)
TRAIN_WATCH = ("gemm", "copy_kernel", "indexing_backward", "reduce_kernel",
               "softmax", "index_elementwise", "scatter", "sort")
TRAIN_FRONT_END = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps",
                   "6", "--batch", "2", "--seq", "64", "--ckpt-every", "3",
                   "--log-every", "1", "--device", "cuda"]


def _leaf_errs(got, want):
    """{dotted path: ||got - want|| / ||want||}, want's device."""
    from repro_torch.core.tree import flatten_with_paths
    out = {}
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want)):
        a, b = a.detach().to(b.device).float(), b.detach().float()
        out[".".join(path)] = float((a - b).norm()
                                    / max(float(b.norm()), 1e-30))
    return out


def _to(tree, device):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.detach().to(device, copy=True), tree)


@contextlib.contextmanager
def ste_operands(record=None, replay=None):
    """Hooks the STE of the fake-quant routes (`kernels.registry.
    fake_quant`) for the `with` block.  record: a list that gets, for each
    quantizing call in call order, (its codes as f32 values, its scales,
    the operand the product consumed), all on the CPU.  replay: such a
    list, whose operands stand in for the computed ones in the same order
    (forward the recorded values, backward the identity, as the STE's);
    every entry must be used.  Checkpointed regions recompute whole (no
    early stop), so the CPU and the card make the same calls."""
    from torch.utils.checkpoint import set_checkpoint_early_stop
    from repro_torch.core.formats import get_format
    from repro_torch.core.quantize import quantize, quantize_blockwise
    from repro_torch.kernels import registry as R
    real, used = R.fake_quant, [0]

    def hooked(x, fmt, *, dim=None, block=None):
        if get_format(fmt).name == "fp32":
            return real(x, fmt, dim=dim, block=block)
        if replay is None:
            out = real(x, fmt, dim=dim, block=block)
            xd = x.detach()
            q, sc = (quantize_blockwise(xd, fmt, dim=dim, block=block)
                     if block is not None and dim is not None
                     else quantize(xd, fmt, dim=dim))
            record.append((q.float().cpu(), sc.cpu(), out.detach().cpu()))
            return out
        i = used[0]
        if i >= len(replay) or replay[i][2].shape != x.shape \
                or replay[i][2].dtype != x.dtype:
            raise AssertionError(f"STE replay: call {i} ({tuple(x.shape)} "
                                 f"{x.dtype}) has no recorded operand of "
                                 f"its shape ({len(replay)} recorded)")
        used[0] += 1
        return replay[i][2].to(x.device) + (x - x.detach())

    R.fake_quant = hooked
    try:
        with set_checkpoint_early_stop(False):
            yield
    finally:
        R.fake_quant = real
    if replay is not None and used[0] != len(replay):
        raise AssertionError(f"STE replay: {used[0]} calls of "
                             f"{len(replay)} recorded")


def ste_flips(got, want):
    """Two `ste_operands` records of one step -> {"codes": codes that
    differ, "code_calls": calls with any, "scales": scales that differ,
    "scale_calls": calls with any, "operands": operand values that
    differ, "n_codes": codes in all, "calls": calls}."""
    if [c.shape for c, _, _ in got] != [c.shape for c, _, _ in want]:
        raise AssertionError(f"STE records of {len(got)} and {len(want)} "
                             f"calls do not pair up")
    out = dict.fromkeys(("codes", "code_calls", "scales", "scale_calls",
                         "operands", "n_codes"), 0)
    for a, b in zip(got, want):
        for key, i in (("codes", 0), ("scales", 1), ("operands", 2)):
            n = int((a[i] != b[i]).sum())
            out[key] += n
            if key != "operands":
                out[key[:-1] + "_calls"] += n > 0
        out["n_codes"] += a[0].numel()
    out["calls"] = len(got)
    return out


def train_step_once(model, state, batch, opt):
    """One loss-and-gradients pass, then one train step, on copies of
    state and batch on the model's device -> (loss, grads, new params)."""
    from repro_torch.distributed.step import (make_loss_fn, make_train_step,
                                              value_and_grad)
    st, b = _to(state, model.device), _to(batch, model.device)
    _, grads = value_and_grad(make_loss_fn(model))(st["params"], b)
    st, met = make_train_step(model, opt)(st, b)
    return float(met["loss"]), grads, st["params"]


def _step_errs(got, want):
    """Two train_step_once results -> (loss rel, worst grad leaf and its
    path, worst param leaf and its path)."""
    g, p = _leaf_errs(got[1], want[1]), _leaf_errs(got[2], want[2])
    gw, pw = max(g, key=g.get), max(p, key=p.get)
    return abs(got[0] / want[0] - 1), g[gw], gw, p[pw], pw


def train_card_vs_cpu():
    """(a) One train step on the card against the same step on the CPU,
    from one state and one batch, for each reduced config and policy,
    with the STE operands that differ counted (and, where any do, the CPU
    step recomputed from the card's)."""
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch.train import build_state
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    out = {}
    for arch in TRAIN_ARCHS:
        for pol in TRAIN_POLICIES:
            cfg = reduce_config(get_config(arch)).replace(
                policy=pol, attn_chunk=16, logits_chunk=16)
            models = {d: build_model(cfg, device=d) for d in ("cpu", "cuda")}
            state = build_state(models["cpu"], 0)
            batch = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                             batch=2, seq=64),
                                  device="cpu").batch(0)
            opt = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                    total_steps=4)
            res, rec = {}, {}
            for dev, m in models.items():
                rec[dev] = []
                with ste_operands(record=rec[dev]):
                    res[dev] = train_step_once(m, state, batch, opt)
            ste = ste_flips(rec["cuda"], rec["cpu"])
            loss_err, g, gw, p, pw = _step_errs(res["cuda"], res["cpu"])
            line = {"loss_rel": loss_err, "grad_leaf": g, "grad_leaf_at": gw,
                    "param_leaf": p, "param_leaf_at": pw, "ste": ste}
            print(f"train (a) {arch} {pol}: loss card {res['cuda'][0]:.6f} "
                  f"cpu {res['cpu'][0]:.6f} (rel {loss_err:.1e}), worst "
                  f"grad leaf {g:.1e} ({gw}), worst param leaf {p:.1e} "
                  f"({pw}); STE card vs CPU over {ste['calls']} calls: "
                  f"codes that differ {ste['codes']} of {ste['n_codes']} "
                  f"(in {ste['code_calls']} calls), scales that differ "
                  f"{ste['scales']} (in {ste['scale_calls']} calls), "
                  f"operand values that differ {ste['operands']}")
            leaf_pin = TRAIN_CPU_LEAF
            if ste["operands"]:
                with ste_operands(replay=rec["cuda"]):
                    replayed = train_step_once(models["cpu"], state, batch,
                                               opt)
                r_loss, rg, rgw, rp, rpw = _step_errs(res["cuda"], replayed)
                line.update(replay_loss_rel=r_loss, replay_grad_leaf=rg,
                            replay_grad_leaf_at=rgw, replay_param_leaf=rp,
                            replay_param_leaf_at=rpw)
                print(f"train (a) {arch} {pol}: the CPU step from the card's "
                      f"STE operands: loss rel {r_loss:.1e}, worst grad leaf "
                      f"{rg:.1e} ({rgw}), worst param leaf {rp:.1e} ({rpw})")
                if r_loss > TRAIN_CPU_RTOL or rg > TRAIN_CPU_LEAF \
                        or rp > TRAIN_CPU_LEAF:
                    raise AssertionError(f"train (a) {arch} {pol}: card vs "
                                         f"the CPU on the card's STE "
                                         f"operands {line}")
                if ste["codes"]:
                    leaf_pin = TRAIN_FLIP_LEAF
            if loss_err > TRAIN_CPU_RTOL or g > leaf_pin or p > leaf_pin:
                raise AssertionError(f"train (a) {arch} {pol}: card vs CPU "
                                     f"(leaf pin {leaf_pin}) {line}")
            out[f"{arch} {pol}"] = line
    return out


def _state_bytes(state):
    from repro_torch.core.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(state))


def train_full_width(cfg):
    """(b) granite-moe-1b-a400m at its published widths: TRAIN_STEPS
    steps of batch TRAIN_B x TRAIN_S on SyntheticLM, seeded weights."""
    import torch
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.distributed.step import make_train_step
    from repro_torch.launch.train import build_state
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    t0 = time.monotonic()
    model = build_model(cfg, device="cuda")
    state = build_state(model, 0)
    torch.cuda.synchronize()
    state_bytes = _state_bytes(state)
    print(f"train (b) model: {cfg.name} {cfg.n_layers} layers d="
          f"{cfg.d_model} policy={cfg.policy} dtype={cfg.dtype} remat="
          f"{cfg.remat} attn_chunk={cfg.attn_chunk} logits_chunk="
          f"{cfg.logits_chunk}; state (params, m, v) {state_bytes / 1e9:.2f} "
          f"GB, built in {time.monotonic() - t0:.1f} s")
    step = make_train_step(model, adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=TRAIN_B, seq=TRAIN_S, seed=0),
                         device="cuda")
    pipe.batch(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batches = [pipe.batch(i) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, walls = [], [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        print(f"train (b) step {len(losses)}: loss {losses[-1]:.4f} "
              f"aux {float(m['aux']):.5f} gnorm {gnorms[-1]:.3f} lr "
              f"{float(m['lr']):.2e} wall {walls[-1]:.1f} ms")
    peak = torch.cuda.max_memory_allocated()
    if not all(map(math.isfinite, losses + gnorms)):
        raise AssertionError(f"train (b): non-finite loss or grad norm "
                             f"{losses} {gnorms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train (b): step {TRAIN_STEPS}'s loss "
                             f"{losses[-1]} is not below step 1's "
                             f"{losses[0]}")
    median = sorted(walls)[len(walls) // 2]
    prof = profile_window("train step granite-moe-1b-a400m",
                          lambda: step(state, batches[0]),
                          watch=TRAIN_WATCH, require=True, warm=False)
    path_roofline("train step granite-moe-1b-a400m", prof,
                  lambda: step(state, batches[0]),
                  (cfg, "train", TRAIN_S, TRAIN_B), median)
    busy = prof["busy_ms"]
    out = {"losses": losses, "grad_norms": gnorms, "step_walls_ms": walls,
           "median_step_ms": median,
           "tokens_per_s": TRAIN_B * TRAIN_S / (median / 1e3),
           "busy_ms": busy, "busy_share": busy / median,
           "profiled_wall_ms": prof["wall_ms"], "top": prof["top"],
           "launches": prof["launches"], "watch": prof["watch"],
           "peak_bytes": peak, "state_bytes": state_bytes,
           "batch_ms": batch_ms}
    print(f"train (b) granite-moe-1b-a400m B {TRAIN_B} x S {TRAIN_S}: "
          f"median step {median:.1f} ms, {out['tokens_per_s']:.1f} trained "
          f"tokens/s, device busy {busy:.1f} ms of the median wall "
          f"({out['busy_share']:.1%}), peak {peak / 1e9:.2f} GB "
          f"(state {state_bytes / 1e9:.2f} GB), one batch() "
          f"{batch_ms:.1f} ms")
    return out


def _equal_trees(a, b):
    """-> the dotted paths of the leaves that differ."""
    import torch
    from repro_torch.core.tree import flatten_with_paths
    return [".".join(p) for (p, x), (_, y) in zip(flatten_with_paths(a),
                                                   flatten_with_paths(b))
            if not torch.equal(x.detach(), y.detach())]


def train_replay(cfg):
    """(c) granite at full width cut to REPLAY_LAYERS layers: a supervised
    run with synchronous checkpoints and an injected failure against a
    clean run, bit for bit."""
    import shutil
    import tempfile
    import torch
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.distributed.step import (make_loss_fn, make_train_step,
                                              value_and_grad)
    from repro_torch.launch.train import build_state
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.runtime import checkpoint as ckpt
    from repro_torch.runtime import fault
    cfg = cfg.replace(n_layers=REPLAY_LAYERS)
    model = build_model(cfg, device="cuda")
    step = make_train_step(model, adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=REPLAY_STEPS))
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=TRAIN_B, seq=TRAIN_S, seed=0),
                         device="cuda")
    # the backward's own repeatability, leaf by leaf
    probe = build_state(model, 0)
    grads = [value_and_grad(make_loss_fn(model))(probe["params"],
                                                 pipe.batch(0))[1]
             for _ in range(2)]
    unrepeatable = _equal_trees(*grads)
    print(f"train (c) gradients of two identical backward passes: "
          f"{'equal bit for bit' if not unrepeatable else unrepeatable}")
    del probe, grads
    clean = build_state(model, 0)
    if _equal_trees(clean, build_state(model, 0)):
        raise AssertionError("train (c): two builds of the state differ")
    for i in range(REPLAY_STEPS):
        clean, _ = step(clean, pipe.batch(i))
    saves, restores = [], []
    save, restore = ckpt.save, ckpt.restore

    def timed_save(*a, **k):
        t0 = time.monotonic()
        out = save(*a, **k)
        saves.append(time.monotonic() - t0)
        return out

    def timed_restore(*a, **k):
        t0 = time.monotonic()
        out = restore(*a, **k)
        torch.cuda.synchronize()
        restores.append(time.monotonic() - t0)
        return out

    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_replay_", dir=ROOT / "build")
    fault.ckpt.save, fault.ckpt.restore = timed_save, timed_restore
    try:
        sup = fault.Supervisor(fault.SupervisorConfig(
            ckpt_dir=d, ckpt_every=REPLAY_EVERY, async_save=False),
            state=build_state(model, 0))
        sup.inject_failure_at = REPLAY_FAIL_AT
        faulty = sup.run(step, pipe.batch, REPLAY_STEPS)
    finally:
        fault.ckpt.save, fault.ckpt.restore = save, restore
        shutil.rmtree(d)
    ckpt_bytes = _state_bytes(faulty)
    differ = _equal_trees(faulty["params"], clean["params"])
    print(f"train (c) {REPLAY_LAYERS}-layer granite, {REPLAY_STEPS} steps, "
          f"checkpoint every {REPLAY_EVERY} ({ckpt_bytes / 1e9:.2f} GB), "
          f"failure at step {REPLAY_FAIL_AT}: events {sup.events}; saves "
          f"{['%.2f s' % t for t in saves]}, restore "
          f"{['%.2f s' % t for t in restores]}; final params "
          f"{'equal the clean run bit for bit' if not differ else differ}")
    if [e[0] for e in sup.events] != ["failure", "restored"]:
        raise AssertionError(f"train (c): events {sup.events}")
    if differ:
        raise AssertionError(f"train (c): the replayed run's params differ "
                             f"from the clean run's at {differ}")
    return {"saves_s": saves, "restores_s": restores,
            "checkpoint_bytes": ckpt_bytes, "events": sup.events,
            "backward_repeatable": not unrepeatable}


def train_front_end():
    """(d) `launch.train.main` in the process, reduced, on the card, with
    async saves."""
    import io
    import shutil
    import tempfile
    from repro_torch.launch import train as TT
    (ROOT / "build").mkdir(exist_ok=True)
    d = tempfile.mkdtemp(prefix="train_front_", dir=ROOT / "build")
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            state = TT.main(TRAIN_FRONT_END + ["--ckpt-dir", d])
        saved = sorted(p.name for p in Path(d).iterdir())
    finally:
        shutil.rmtree(d)
    lines = buf.getvalue().splitlines()
    for ln in lines:
        print("train (d) front end: " + ln)
    done = [ln for ln in lines if ln.startswith("done: ")]
    if state is None or not done or int(state["opt"]["count"]) != 6:
        raise AssertionError(f"train (d): front end returned {state!r}, "
                             f"printed {lines}")
    if saved != ["LATEST", "step_00000002", "step_00000005"]:
        raise AssertionError(f"train (d): checkpoints {saved}")
    return {"done": done[0]}


def run_training():
    """Phase 5: (a)-(d), with every kernel's launch counter held at 0 (the
    train step takes the torch routes)."""
    import torch
    from repro_torch.configs import get_config
    zero_counts()
    t0 = time.monotonic()
    out = {"card_vs_cpu": train_card_vs_cpu()}
    t_a = time.monotonic()
    granite = get_config("granite-moe-1b-a400m")
    out["full_width"] = train_full_width(granite)
    gc.collect()
    torch.cuda.empty_cache()
    t_b = time.monotonic()
    out["replay"] = train_replay(granite)
    gc.collect()
    torch.cuda.empty_cache()
    t_c = time.monotonic()
    out["front_end"] = train_front_end()
    t_d = time.monotonic()
    counts = read_counts()
    check_counts("training", counts, {})
    print("kernel launch counters after training: " + json.dumps(counts))
    out["kernel_launches"] = sum(counts.values())
    out["seconds"] = {"a": t_a - t0, "b": t_b - t_a, "c": t_c - t_b,
                      "d": t_d - t_c}
    print(f"training phase: (a) {t_a - t0:.1f} s, (b) {t_b - t_a:.1f} s, "
          f"(c) {t_c - t_b:.1f} s, (d) {t_d - t_c:.1f} s; hand-written "
          f"kernel launches {out['kernel_launches']}")
    return out


# -----------------------------------------------------------------------------
# phase 6: tensor parallelism on one card (two gloo ranks sharing it)
# -----------------------------------------------------------------------------

TP_RANKS = 2
TP_BACKEND = "gloo"               # NCCL refuses two ranks on one card
TP_TIMEOUT = 600.0                # s the ranks may take, both paths
TP_REQUESTS = 2                   # the first of phase 3's 8 requests,
TP_NEW = 4                        # each cut to this many new tokens
TP_PREFIX = 40                    # shared prefix: 2.5 pages of 16, a CoW
TP_SPEC_K = 2                     # one self-draft round of k tokens
TP_TRAIN_B, TP_TRAIN_S, TP_TRAIN_STEPS = 1, 1024, 2   # per rank
# granite-moe-1b's depth in the TP train steps: 6 of its 24 layers (the
# f32 route's gradients cross host memory)
TP_TRAIN_LAYERS = 6
TP_REPORT = ("tp", "tp_requested", "tp_fallback_reason", "decode_route",
             "verify_route", "draft_route", "tp_backend",
             "tp_wire_staged_through_host", "tp_wire_bytes_per_step_layer",
             "tp_wire_bytes_per_step", "pool_bytes_per_device",
             "pool_bytes_allocated_per_device", "prefix_hits",
             "prefix_cow_copies", "acceptance_rate", "spec_rounds",
             "decode_steps", "prefill_calls", "gen_tokens", "wall_s")


def tp_serving(cfg, model, params, ecfg, tp):
    """Phase 6's three eager engine runs at TP width `tp` (1: the
    reference, in this process): greedy over the first TP_REQUESTS of
    phase 3's requests, cut to TP_NEW new tokens; two requests of 4 new
    tokens behind a TP_PREFIX-token shared
    prefix served one after the other with the prefix cache on (the
    second hits, with a copy-on-write page); one self-draft request of
    one round of TP_SPEC_K tokens on the split-K route.  Each run's
    counters are zeroed just before `Engine.run` and read just after,
    and held to the launches the run implies.  -> {run: tokens, counts,
    report, decode-step walls}."""
    import dataclasses

    import torch
    from repro_torch.launch.engine import (Engine, Request,
                                           synthetic_workload)
    from repro_torch.serving.spec_decode import SpecConfig

    def one(name, ecfg_, reqs, spec=None, sequential=False):
        engine = Engine(model, params, dataclasses.replace(ecfg_, tp=tp),
                        device="cuda", graphs=False, spec=spec)
        walls, decode = [], engine._decode_batch

        def timed(now):
            t0 = time.perf_counter()
            n = decode(now)
            if n:
                walls.append((time.perf_counter() - t0) * 1e3)
            return n
        engine._decode_batch = timed
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.monotonic()
        if sequential:
            for r in reqs:
                engine.run([r])
            rep = engine.report(time.monotonic() - t0)
        else:
            rep = engine.run(reqs)
        torch.cuda.synchronize()
        counts = read_counts()
        check_counts(f"{cfg.name} tp={tp} {name}", counts,
                     engine_counts(cfg, rep, spec_rungs(engine)))
        out = {"tokens": [list(r.out_tokens) for r in reqs],
               "counts": counts,
               "report": {k: rep[k] for k in TP_REPORT if k in rep},
               "decode_step_ms": sorted(walls)[len(walls) // 2]
               if walls else None}
        del engine
        gc.collect()
        return out

    first = workload(cfg)[:TP_REQUESTS]
    for r in first:
        r.max_new = min(r.max_new, TP_NEW)
    spec_req = Request(rid=0, prompt=first[0].prompt, max_new=TP_SPEC_K + 2)
    return {
        "greedy": one("greedy", ecfg, first),
        "prefix": one("prefix", dataclasses.replace(ecfg, prefix_cache=True),
                      synthetic_workload(2, vocab=cfg.vocab_size, seed=1,
                                         prompt_range=(24, 40),
                                         gen_range=(4, 4),
                                         shared_prefix=TP_PREFIX),
                      sequential=True),
        "spec": one("spec", ecfg, [spec_req],
                    spec=SpecConfig(cfg.policy, k=TP_SPEC_K))}


def gloo_cuda_all_gather(group) -> dict:
    """Whether this torch's gloo all_gather takes CUDA tensors (PyTorch
    documents gloo on the GPU for all_reduce and broadcast only).  A
    probe, reported: the wire stages CUDA tensors through host memory
    under gloo whatever it finds (`distributed.tp.STAGES_THROUGH_HOST`)."""
    import torch
    import torch.distributed as dist
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    x = torch.full((4,), float(rank), device="cuda")
    parts = [torch.empty_like(x) for _ in range(n)]
    try:
        dist.all_gather(parts, x, group=group)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        return {"takes_cuda": False, "error": str(exc).splitlines()[0][:200]}
    return {"takes_cuda": True, "exact": all(
        bool((p == float(i)).all()) for i, p in enumerate(parts))}


def tp_train(rank, group) -> dict:
    """granite-moe-1b-a400m at full width (`TP_TRAIN_LAYERS` of its
    layers) under fp8_dpa, data-parallel:
    each rank steps TP_TRAIN_STEPS times on its TP_TRAIN_B x TP_TRAIN_S
    row of the seeded batch, through `make_compressed_train_step` on the
    f32 route and on the E4M3 wire, from the same seeded state; each
    route's losses, step walls, residual, per-rank wire bytes and
    whether every rank's params are the same bits.  Rank 0 then runs the
    single-process references: the same rows' gradients in one process,
    averaged in rank order and one AdamW update a step (what the f32
    route computes across ranks; each route's largest param difference
    from it).  Not against `make_train_step` on the joined batch: under
    fp8_dpa its activation scales are per tensor and see both rows, so
    its loss is another function's (PERF.md §6, PR 30)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quantize import recip
    from repro_torch.core.tree import flatten_with_paths, leaves, tree_map
    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.step import (init_err_state,
                                              make_compressed_train_step,
                                              make_loss_fn, value_and_grad)
    from repro_torch.launch.train import build_state
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    cfg = get_config("granite-moe-1b-a400m").replace(
        policy="fp8_dpa", n_layers=TP_TRAIN_LAYERS)
    model = build_model(cfg, device="cuda")
    opt = adamw.AdamWConfig(lr=1e-3, total_steps=10)   # the reference test's
    pipe = make_pipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    batch=TP_RANKS * TP_TRAIN_B,
                                    seq=TP_TRAIN_S, seed=0), device="cuda")
    batches = [pipe.batch(i) for i in range(TP_TRAIN_STEPS)]

    def rows(b, r):
        return {k: v[r * TP_TRAIN_B:(r + 1) * TP_TRAIN_B].contiguous()
                for k, v in b.items()}
    out, kept = {}, {}
    for fmt in (None, "fp8_e4m3"):
        state = build_state(model, 0)
        state["err"] = init_err_state(state["params"])
        step = make_compressed_train_step(model, opt, group, fmt_name=fmt)
        losses, walls = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, rows(b, rank))
            losses.append(float(m["loss"]))
            walls.append((time.perf_counter() - t0) * 1e3)
        route = fmt or "f32"
        out[route] = {
            "losses": losses, "step_walls_ms": walls,
            "err_max": max(float(e.abs().max()) for e in
                           leaves(state["err"])),
            "replicas_agree": C.replicas_agree(state["params"], group),
            "wire_bytes_per_step": C.wire_bytes(state["params"],
                                                fmt or "fp32")}
        if rank == 0:
            kept[route] = {p: t.detach().clone() for p, t in
                           flatten_with_paths(state["params"])}
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        grad_fn = value_and_grad(make_loss_fn(model))
        state = build_state(model, 0)
        losses = []
        for b in batches:
            # the ranks' rows one after the other, their gradients and
            # losses summed in rank order as they come
            (_, parts), grads = grad_fn(state["params"], rows(b, 0))
            loss = parts["loss"].clone()
            for r in range(1, TP_RANKS):
                (_, parts), more = grad_fn(state["params"], rows(b, r))
                tree_map(lambda g, m: g.add_(m), grads, more)
                loss += parts["loss"]
                del more
            grads = tree_map(lambda g: g.mul_(recip(TP_RANKS)), grads)
            adamw.update(opt, grads, state["opt"], state["params"],
                         model.decay_mask(state["params"]))
            losses.append(float(loss * recip(TP_RANKS)))
            del grads
        final = dict(flatten_with_paths(state["params"]))
        diffs = {route: max(float((final[p] - t).abs().max())
                            for p, t in params.items())
                 for route, params in kept.items()}
        del state, final, kept
        out["single"] = {"losses": losses, "max_param_diff": diffs}
    return out


def _tp_rank(rank, device, qwen, ecfg):
    """One rank of phase 6 (run by `launch.mesh.run_ranks`, the group
    active): the gloo probe, the TP serving runs on its own full-width
    qwen3-4b (the seeded weights of this process's phase 3a), then the
    compressed train steps; each path's peak memory."""
    import torch
    from repro_torch.distributed import tp as TP
    from repro_torch.kernels import build as kbuild
    kbuild.load_library()
    group = TP.active_group()
    out = {"gloo_cuda_all_gather": gloo_cuda_all_gather(group)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model, params = build(qwen)
    out["serving"] = tp_serving(qwen, model, params, ecfg, TP_RANKS)
    out["serving_peak_gb"] = _peak_gb()
    out["serving_s"] = time.monotonic() - t0
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out["train"] = tp_train(rank, group)
    out["train_peak_gb"] = _peak_gb()
    out["train_s"] = time.monotonic() - t0
    return out


def run_tp(qwen, ecfg):
    """Phase 6: tensor parallelism on one card.  The tp=1 eager engine
    serves phase 6's runs here (`tp_serving`) on phase 3a's seeded
    weights; then TP_RANKS gloo ranks share the card (`run_ranks`),
    each serving the same runs at tp=TP_RANKS on its own copy of the
    weights and stepping the compressed train step (`tp_train`).  Holds:
    every rank at tp 2 with no fallback on the sharded routes, its
    tokens equal to tp=1's bit for bit, its launch counts (paged decode,
    split-K) equal to tp=1's; the train step's losses equal across
    ranks, the f32 route's losses and params within 1e-4 of the single
    process and a zero residual, the E4M3 wire's first loss within 1e-3
    and params within 5e-3 and a live residual, every rank's params the
    same bits on both routes.  Everything is printed before it is
    held."""
    import torch
    from repro_torch.launch.mesh import run_ranks
    t0 = time.monotonic()
    model, params = build(qwen)
    ref = tp_serving(qwen, model, params, ecfg, 1)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    t_ref = time.monotonic() - t0
    store = ROOT / "build" / f"tp_store_{int(time.time() * 1e3)}"
    store.parent.mkdir(parents=True, exist_ok=True)
    t1 = time.monotonic()
    ranks = run_ranks(_tp_rank, TP_RANKS, backend=TP_BACKEND, device="cuda",
                      timeout=TP_TIMEOUT, init_method=f"file://{store}",
                      args=(qwen, ecfg))
    t_ranks = time.monotonic() - t1
    train = [res["train"] for res in ranks]
    single = train[0]["single"]
    g = ref["greedy"]
    r0 = ranks[0]["serving"]["greedy"]
    rep = r0["report"]
    print(f"tp: {TP_RANKS} {TP_BACKEND} ranks on one card: tp=1 reference "
          f"{t_ref:.1f} s, the ranks {t_ranks:.1f} s (serving "
          f"{[round(r['serving_s'], 1) for r in ranks]} s, training "
          f"{[round(r['train_s'], 1) for r in ranks]} s); pool "
          f"{rep['pool_bytes_allocated_per_device'] / 1e6:.2f} MB allocated "
          f"a rank ({rep['pool_bytes_per_device'] / 1e6:.3f} MB of pages in "
          f"use), wire {rep['tp_wire_bytes_per_step'] / 1e6:.2f} MB a decode "
          f"step ({rep['tp_wire_bytes_per_step_layer'] / 1e3:.1f} KB a "
          f"layer), staged through host memory "
          f"{rep['tp_wire_staged_through_host']}; decode step median "
          f"{r0['decode_step_ms']:.1f} ms at tp {TP_RANKS} vs "
          f"{g['decode_step_ms']:.1f} ms at tp 1 (greedy wall tp 1 "
          f"{g['report']['wall_s']:.2f} s, rank 0 {rep['wall_s']:.2f} s); "
          "gloo all_gather on CUDA tensors: "
          f"{ranks[0]['gloo_cuda_all_gather']}")
    print(f"tp train (granite-moe-1b-a400m fp8_dpa, {TP_RANKS} x B "
          f"{TP_TRAIN_B} x S {TP_TRAIN_S}): f32 route losses "
          f"{train[0]['f32']['losses']}, E4M3 wire "
          f"{train[0]['fp8_e4m3']['losses']}, single process (the ranks' "
          f"rows) {single['losses']}; max param diff from the single "
          f"process {single['max_param_diff']}; E4M3 residual max "
          f"{train[0]['fp8_e4m3']['err_max']:.3e}; wire a step a rank f32 "
          f"{train[0]['f32']['wire_bytes_per_step'] / 1e9:.3f} GB, E4M3 "
          f"{train[0]['fp8_e4m3']['wire_bytes_per_step'] / 1e9:.3f} GB")
    for i, r in enumerate(ranks):
        walls = {k: [round(w, 1) for w in r["train"][k]["step_walls_ms"]]
                 for k in ("f32", "fp8_e4m3")}
        print(f"tp rank {i}: peak {r['serving_peak_gb']:.2f} GB serving, "
              f"{r['train_peak_gb']:.2f} GB training; train steps (ms) f32 "
              f"{walls['f32']}, E4M3 {walls['fp8_e4m3']}")
    bad = []
    for rank, res in enumerate(ranks):
        for name, want in ref.items():
            got = res["serving"][name]
            rrep = got["report"]
            if rrep["tp"] != TP_RANKS or "tp_fallback_reason" in rrep or \
                    rrep["decode_route"] != "paged_decode_sharded":
                bad.append(f"rank {rank} {name}: report {rrep}")
            if got["tokens"] != want["tokens"]:
                bad.append(f"rank {rank} {name}: tokens {got['tokens']} != "
                           f"tp=1's {want['tokens']}")
            if got["counts"] != want["counts"]:
                bad.append(f"rank {rank} {name}: launches {got['counts']} "
                           f"!= tp=1's {want['counts']}")
        if res["serving"]["spec"]["report"]["verify_route"] != \
                "verify_attn_sharded":
            bad.append(f"rank {rank}: spec verify route")
        if not res["serving"]["prefix"]["report"]["prefix_cow_copies"]:
            bad.append(f"rank {rank}: no prefix hit with a CoW page")
    # the f32 route against the single process on every step's loss and
    # the params (tests/test_distributed.py's 1e-4); the E4M3 wire, as the
    # reference's test holds it, on the loss entering its update (1e-3)
    # and the params after it (5e-3), with a live residual; its later
    # losses are reported (PERF.md)
    for route, n_loss, tol, p_tol in (("f32", TP_TRAIN_STEPS, 1e-4, 1e-4),
                                      ("fp8_e4m3", 1, 1e-3, 5e-3)):
        losses = [t[route]["losses"] for t in train]
        if any(x != losses[0] for x in losses[1:]):
            bad.append(f"train {route}: the ranks' losses differ {losses}")
        errs = [abs(a - b) for a, b in zip(losses[0][:n_loss],
                                           single["losses"])]
        if max(errs) >= tol or single["max_param_diff"][route] >= p_tol:
            bad.append(f"train {route}: loss diffs {errs} (tol {tol}), "
                       f"param diff {single['max_param_diff'][route]} "
                       f"(tol {p_tol})")
        if not all(t[route]["replicas_agree"] for t in train):
            bad.append(f"train {route}: params differ between ranks")
        if [t[route]["err_max"] > 0 for t in train] != \
                [route != "f32"] * TP_RANKS:
            bad.append(f"train {route}: residuals "
                       f"{[t[route]['err_max'] for t in train]}")
    if bad:
        raise AssertionError("phase 6: " + "; ".join(bad))
    print(f"tp: every rank's tokens equal the tp=1 eager engine's in all "
          f"{len(ref)} runs (greedy, a prefix hit with a CoW copy, one "
          "self-draft round), launch counts equal tp=1's; the train step's "
          "params the same bits on every rank on both routes")
    out = {"seconds": {"tp1_reference": t_ref, "ranks": t_ranks},
           "launches": add_counts(
               *[v["counts"] for v in ref.values()],
               *[v["counts"] for r in ranks for v in r["serving"].values()]),
           "tp1": {k: {"report": v["report"], "counts": v["counts"],
                       "decode_step_ms": v["decode_step_ms"]}
                   for k, v in ref.items()},
           "ranks": [{"gloo_cuda_all_gather": r["gloo_cuda_all_gather"],
                      "serving": {k: {"report": v["report"],
                                      "decode_step_ms": v["decode_step_ms"]}
                                  for k, v in r["serving"].items()},
                      "serving_peak_gb": r["serving_peak_gb"],
                      "serving_s": r["serving_s"], "train": r["train"],
                      "train_peak_gb": r["train_peak_gb"],
                      "train_s": r["train_s"]} for r in ranks]}
    return out


def profile_engine(model, params, ecfg, sampler=None,
                   modes=("eager", "graphed"), prefill=True):
    """One steady decode step (4 live requests; the scheduler's host work,
    the step and its token read-back) and one 32-token prefill chunk,
    each profiled on an eager engine and on a graphed one (`modes`; the
    prefill chunk unless `prefill` is off), drawing under `sampler`."""
    import torch
    from repro_torch.launch.engine import DECODE, Engine, synthetic_workload

    out = {}
    for mode in modes:
        engine = Engine(model, params, ecfg, sampler=sampler, device="cuda",
                        graphs=mode == "graphed")
        reqs = synthetic_workload(ecfg.max_batch, vocab=model.cfg.vocab_size,
                                  seed=1, prompt_range=(64, 64),
                                  gen_range=(32, 32))
        for r in reqs:
            engine.submit(r)
        while any(r.state != DECODE for r in reqs):
            engine.step()
        engine.step()
        tag = "sampled " if sampler is not None and not sampler.greedy \
            else ""
        windows = {f"{tag}decode step (B=4)":
                   lambda: engine._decode_batch(0.0)}
        if prefill:
            chunk = torch.zeros((1, ecfg.prefill_chunk), dtype=torch.int64,
                                device="cuda")
            windows["prefill chunk (32 tokens)"] = lambda: engine._prefill(
                tokens=chunk, index=0)
        cells = {f"{tag}decode step (B=4)": (model.cfg, "decode", 64,
                                             ecfg.max_batch),
                 "prefill chunk (32 tokens)": (model.cfg, "prefill",
                                               ecfg.prefill_chunk, 1)}
        out[mode] = {}
        for name, fn in windows.items():
            label = f"{model.cfg.name} {name}, {mode}"
            prof = profile_window(label, fn, watch=("dpa_fused_kernel",
                                                    "paged_decode"), timed=3)
            path_roofline(label, prof, fn, cells[name])
            out[mode][name] = prof
        del engine
    return out


# small kernels each profiled window launches, and waits for, before its
# call: the profiler loses the first records of a profiling run now and
# then (from a few to over a hundred on an H100), and these take the
# loss; their records (LEAD_KERNEL) are left out of the window
PROFILE_LEAD = 128
LEAD_KERNEL = "spin_kernel"      # torch.cuda._sleep's


def profile_window(label, fn, watch=(), require=False, timed=0,
                   warm=True):
    """torch.profiler over one call of fn after a warm-up call (unless
    `warm` is off: fn ran just before): wall time,
    device busy time and share, launches, the top kernels by device
    time, and for each name in `watch` the device time and share of the
    kernels whose names contain it.  A session that records no device
    activity (short ones sometimes do not) is tried again, up to four
    times; with `require` a fourth empty one fails.  With `timed`, also
    the median host wall of that many calls outside the profiler (its
    tracing stretches the gaps between a graph's kernels), each ended by
    a synchronize, and the busy share against it.  Also the launch
    counters' change over the profiled call (`work`) and, for each route
    table's kernels (`PROFILE_ROUTES`), their records and device ms
    (`routes`).  The call follows `PROFILE_LEAD` small kernels, which the
    window leaves out."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import counters
    if warm:
        fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if attempt:
            time.sleep(1.0)
        before = counters.snapshot()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_LEAD):
                torch.cuda._sleep(0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        work = {k: v for k, v in counters.diff(counters.snapshot(),
                                               before).items() if v}
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = [e for e in device if LEAD_KERNEL not in e.name]
        if kernels:
            break
    lead = len(device) - len(kernels)
    by_name, records = {}, {}
    for e in kernels:
        dt = (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + dt
        records[e.name] = records.get(e.name, 0) + 1
    busy = sum(by_name.values())
    # each route table's kernels: [records, device ms]
    routes = {" + ".join(keys): [
        sum(n for k, n in records.items() if kname in k),
        sum(v for k, v in by_name.items() if kname in k)]
        for kname, keys in PROFILE_ROUTES.items()}
    if not kernels:
        if require:
            raise AssertionError(f"profile {label}: four sessions saw no "
                                 "device events")
        print(f"profile {label}: wall {wall_ms:.1f} ms; the profiler saw no "
              "device events (busy share not measured)")
        return {"wall_ms": wall_ms, "busy_ms": None,
                "unprofiled_wall_ms": None, "work": work, "routes": routes}
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
          f"launches (lead-in: {lead} of {PROFILE_LEAD} records)"
          + ("" if bare_ms is None else
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
            "top": [[k[:100], v] for k, v in top], "watch": watched,
            "work": work, "routes": routes}


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


def sampled_summary(greedy, greedy_prof, sampled, prefix, front):
    """One line each: the graphed sampled decode step beside the greedy
    one, the sampled engine's tokens/s, the prefix cache's cold and warm
    TTFT, and the front end's report."""
    def step(p):
        if p.get("busy_ms") is None:
            return "busy not measured"
        return (f"{p['busy_ms']:.3f} device ms in "
                f"{p['unprofiled_wall_ms']:.2f} ms unprofiled, "
                f"{p['launches']} launches")
    print(f"summary qwen3-4b decode step graphed: sampled "
          f"{step(sampled['sampled_step_profile'])}; greedy "
          f"{step(greedy_prof['graphed']['decode step (B=4)'])}")
    print(f"summary qwen3-4b sampled engine: graphed "
          f"{sampled['tokens_per_s']:.2f} tok/s (greedy "
          f"{greedy['tokens_per_s']:.2f}), eager "
          f"{sampled['eager']['tokens_per_s']:.2f} tok/s; TTFT p50 "
          f"{sampled['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
          f"{sampled['p50_latency_s'] * 1e3:.0f} ms p99 "
          f"{sampled['p99_latency_s'] * 1e3:.0f} ms")
    cold = prefix["cold"]
    print(f"summary qwen3-4b prefix cache: {prefix['prefill_tokens_saved']}"
          f" prefill tokens saved, hit rate {prefix['prefix_hit_rate']:.2f};"
          f" TTFT p50 cold {cold['p50_ttft_s'] * 1e3:.0f} ms, warm "
          f"{prefix['p50_ttft_s'] * 1e3:.0f} ms; tokens/s cold "
          f"{cold['tokens_per_s']:.2f}, warm {prefix['tokens_per_s']:.2f}")
    print(f"summary qwen3-4b front end: {front['tokens_per_s']:.2f} tok/s, "
          f"TTFT p50 {front['p50_ttft_s'] * 1e3:.0f} ms, latency p50 "
          f"{front['p50_latency_s'] * 1e3:.0f} ms p99 "
          f"{front['p99_latency_s'] * 1e3:.0f} ms")


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
    ROOFLINE.clear()
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

    # phase 2: every kernel against its plain version, each check's
    # seconds kept
    checks = {}

    def check(name, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        checks[name] = time.monotonic() - t0
        return out

    mm_err, mm_t = check("matmul qwen3-4b", check_matmul, qwen, gen,
                         _dense_shapes(qwen), COLD_LAYERS)
    gmm_err, gmm_t = check("matmul granite", check_matmul, granite, gen,
                           _dense_shapes(granite), COLD_LAYERS)
    tl_err, tl_t = check("tiled", check_fused_tiled, qwen, gen,
                         _dense_shapes(qwen))
    tune = check("tuner", run_tuner, gen)
    pd_err, pd_t = check("paged qwen3-4b", check_paged, qwen, pol, gen,
                         ecfg)
    gpd_err, gpd_t = check("paged granite", check_paged, granite, pol, gen,
                           ecfg)
    pdf_t = check("paged formats qwen3-4b", check_paged_formats, qwen, gen,
                  ecfg)
    gpdf_t = check("paged formats granite", check_paged_formats, granite,
                   gen, ecfg)
    fold_t = check("fold qwen3-4b", check_verify_fold, qwen, gen, ecfg)
    gfold_t = check("fold granite", check_verify_fold, granite, gen, ecfg)
    gf_err, gf_t = check("grouped", check_grouped_fused, granite, gen)
    pq_t = check("prequant", check_prequant, granite, gen)
    dp_t = check("datapath", check_datapath)
    pqo_t = check("prequant oracle", check_prequant_oracle)
    pqf_t = check("prequant formats", check_prequant_formats, granite, gen)
    t_dp = sum(checks[k] for k in ("datapath", "prequant oracle",
                                   "prequant formats"))
    print(f"datapath phase: {t_dp:.1f} s")
    fa_t = check("flash", check_flash, gen)
    dfa_t = check("dpa flash", check_dpa_flash, gen)
    # phase 2m: the fused matmul's and DPA flash's new formats (paged
    # decode's ran in check_paged_formats and check_verify_fold)
    ff_t = check("fused formats", check_fused_formats, qwen, granite, gen)
    dff_t = check("dpa flash formats", check_dpa_flash_formats, gen)
    t_fmt = checks["fused formats"] + checks["dpa flash formats"]
    print(f"formats phase: {t_fmt:.1f} s")
    qz_t = check("quantizers", check_quantizers, gen)
    print("phase 2 checks (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in checks.items()))
    gc.collect()
    torch.cuda.empty_cache()
    t_kernels = time.monotonic() - t_start

    # phase 3a / 4: qwen3-4b through the engine, eager and graphed
    model, params, rep_q, n_q, greedy_q = run_engine(qwen, ecfg, tuned=True)
    prof_q = profile_engine(model, params, ecfg)
    t_engine_q = time.monotonic() - t_start
    # phase 3g / 4: sampled decoding; phase 3h: the prefix cache
    rep_s, n_s = run_sampled(qwen, ecfg, model, params, greedy_q, prof_q)
    rep_p, n_p = run_prefix(qwen, ecfg, model, params)
    t_sampled = time.monotonic() - t_start
    # phase 3j: speculative decoding and the adaptive draft ladder
    rep_j, n_j = run_spec(qwen, ecfg, model, params, greedy_q, rep_q)
    del model
    gc.collect()
    t_spec = time.monotonic() - t_start
    # phase 3d: qwen3-4b's long-prompt prefill under its own policy
    # (fp8_dpa) with use_flash, on the engine's params
    n_c, pre_c = run_prefill(get_config("qwen3-4b").replace(use_flash=True),
                             params)
    # phase 3e: full-sequence scoring under w4a8_kv4_attn8 with use_flash
    n_d, score_d = run_scoring(qwen.replace(use_flash=True), params)
    t_d = time.monotonic() - t_start
    # phase 3m on the same params: path L (fp4_dpa_fused: generate, and
    # scoring with use_flash), path N (DPA flash in fp16 and E2M1
    # attention), path M (the engine under the paged presets)
    n_lq, gen_lq = run_fused_generate(qwen.replace(policy=FUSED_PRESET),
                                      params)
    n_ls, score_l = run_fused_scoring(
        qwen.replace(policy=FUSED_PRESET, use_flash=True), params)
    n_nn, flash_n = run_flash_formats(qwen, params)
    n_mm, paged_m = run_paged_presets(qwen, ecfg, params)
    t_paths = time.monotonic() - t_start - t_d
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_qwen = time.monotonic() - t_start
    # phase 3i: the front end, one `launch.serve.main` call; phase 3j's
    # adaptive front end, another
    rep_f, n_f = run_front_end(qwen)
    gc.collect()
    torch.cuda.empty_cache()
    rep_fa, n_fa = run_front_end_adaptive(qwen)
    gc.collect()
    torch.cuda.empty_cache()
    t_front = time.monotonic() - t_start

    # phase 3b / 4: granite-moe-1b through the engine (path A), eager and
    # graphed
    model, params, rep_g, n_g, _ = run_engine(granite, ecfg)
    prof_g = profile_engine(model, params, ecfg)
    # phase 3c / 4: granite-moe-1b through generate under fp4_dpa_packed
    # (path B), on the same weights prepared for that policy, eager and
    # graphed
    n_b, gen_b = run_generate(granite.replace(policy="fp4_dpa_packed"),
                              params)
    # phase 3m, path L: granite-moe-1b through generate under
    # fp4_dpa_fused (E2M1 activations, dense and grouped)
    t_lg = time.monotonic()
    n_lg, gen_lg = run_fused_generate(granite.replace(policy=FUSED_PRESET),
                                      params)
    t_paths += time.monotonic() - t_lg
    del model, params
    t_granite = time.monotonic() - t_start
    # phase 3f: the quantize_pack op
    n_qp = run_quantize_op(gen)
    gc.collect()
    torch.cuda.empty_cache()
    t_quant = time.monotonic() - t_start
    # phase 3k: the recurrent families at full width (paths G, H, I) and
    # the DPA flash kernel's hd 256 instance
    n_rec, rec, wide_t = run_recurrent(gen)
    t_rec = time.monotonic() - t_start
    # phase 3l: the encoder-decoder and VLM families at full width (paths
    # J, K)
    n_fam, fam = run_families()
    t_fam = time.monotonic() - t_start
    # phase 5: training
    train = run_training()
    gc.collect()
    torch.cuda.empty_cache()
    t_train = time.monotonic() - t_start
    # phase 6: tensor parallelism, two gloo ranks sharing the card
    tp = run_tp(qwen, ecfg)
    t_total = time.monotonic() - t_start
    print(f"phase times: kernels {t_kernels:.1f} s (of which the tuner "
          f"{tune['seconds']:.1f} s), qwen3-4b engine "
          f"{t_engine_q - t_kernels:.1f} s (of which the tuner's engine "
          f"pseudo-op {rep_q['tuned']['seconds']:.1f} s), qwen3-4b sampled and prefix "
          f"cache {t_sampled - t_engine_q:.1f} s, qwen3-4b speculative "
          f"{t_spec - t_sampled:.1f} s, qwen3-4b prefill and "
          f"scoring {t_d - t_spec:.1f} s, the formats' paths L, M, N "
          f"{t_paths:.1f} s (phase 2m {t_fmt:.1f} s), front ends "
          f"{t_front - t_qwen:.1f} s, granite-moe-1b "
          f"{t_granite - t_front:.1f} s, quantize_pack op "
          f"{t_quant - t_granite:.1f} s, recurrent families "
          f"{t_rec - t_quant:.1f} s, encoder-decoder and VLM "
          f"{t_fam - t_rec:.1f} s, training {t_train - t_fam:.1f} s, "
          f"tensor parallelism {t_total - t_train:.1f} s")
    n_serve = add_counts(n_q, n_g, n_s, n_p, n_f, n_j, n_fa)
    # phase 6: the tp=1 reference's runs and every rank's
    n_tp = tp["launches"]
    # phase 3m's paths: L (generate, scoring), M (engine), N (scoring)
    n_fmt = add_counts(n_lq, n_lg, n_ls, n_mm, n_nn)
    every = add_counts(n_serve, n_d, n_rec, n_fam, n_tp, n_fmt)

    def times(t):
        return {k: t[k] for k in TIME_KEYS + ("bound_ms",)}

    # phase 3l's fused-matmul holds: layer 0's linears at the paths' shapes
    fam_mm = {
        "whisper-medium encoder, tiled M 3000 / 3072":
            fam["whisper-medium"]["tiled_max_abs_err"],
        "whisper-medium decoder decode step, split-K M 2 and cross K/V "
        "tiled": fam["whisper-medium"]["decoder_linears_max_abs_err"],
        "pixtral-12b scoring, tiled M 4096":
            fam["pixtral-12b"]["tiled_max_abs_err"],
        "pixtral-12b decode step, split-K M 1":
            fam["pixtral-12b"]["splitk_max_abs_err"]}

    def lib(t):
        return {k: t[k] for k in ("library_ms", "library_device_ms")}

    def unprofiled(r):
        """A path's report without its profile (printed on its own)."""
        return {k: v for k, v in r.items() if k != "profile"}

    def tuned(*routes):
        """The tuner phase's (route, shape)s of these routes: static and
        tuned device ms, the tuned knobs."""
        return [{k: r[k] for k in ("route", "policy", "shape", "static_ms",
                                   "tuned_ms", "tuned_knobs", "ratio")}
                for r in tune["table"] if r["route"] in routes]

    kernels = [
        {"name": "dpa_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_matmul.py:184",
         "launches": n_serve["dpa_matmul_fused"] + n_d["dpa_matmul_fused"]
         + n_rec["dpa_matmul_fused"]
         + n_fam["dpa_matmul_fused"] + n_tp["dpa_matmul_fused"]
         + n_fmt["dpa_matmul_fused"],
         "splitk_launches": n_serve["dpa_matmul_fused.splitk"]
         + n_rec["dpa_matmul_fused.splitk"]
         + n_fam["dpa_matmul_fused.splitk"]
         + n_tp["dpa_matmul_fused.splitk"]
         + n_fmt["dpa_matmul_fused.splitk"],
         "launches_by_x_format": {
             f: every[f"dpa_matmul_fused.{f}"] for f in FUSED_X_FMTS},
         "x_formats": {f: {k: ff_t[f][k] for k in (
             "max_abs_err", "decode_layer", "tiled_layer",
             "grouped_decode_layer")} for f in NEW_ACT_FMTS},
         "path_l": {"qwen3-4b generate": gen_lq,
                    "granite-moe-1b generate": gen_lg,
                    "qwen3-4b scoring": unprofiled(score_l)},
         "tp_launches": n_tp["dpa_matmul_fused"],
         "max_abs_err": max(mm_err, gmm_err, tl_err, *fam_mm.values()),
         **times(mm_t),
         "families": fam_mm,
         "device_from": mm_t.get("device_from"),
         "bound_by": "bytes", "library_ms": None,
         "cold": mm_t["cold"], "plans": mm_t["plans"],
         "tuner": tuned("cuda_fused"),
         "at": "qwen3-4b, one decoder layer's 7 projections at decode M=4 "
               f"(padded to 8), split-K route; cold: {COLD_LAYERS} layers' "
               "weights",
         "granite": {"max_abs_err": gmm_err, **times(gmm_t),
                     "cold": gmm_t["cold"], "plans": gmm_t["plans"],
                     "at": "granite-moe-1b, one layer's 4 attention "
                           "projections at decode M=4 (padded to 8); cold: "
                           "24 layers' weights"},
         "tiled": {
             "name": "dpa_matmul_fused", "route": "cuda",
             "source": "src/repro_torch/csrc/dpa_fused_tiled.cu",
             "replaces": "src/repro/kernels/dpa_matmul.py:184",
             "launches": n_d["dpa_matmul_fused.tiled"]
             + n_rec["dpa_matmul_fused.tiled"]
             + n_fam["dpa_matmul_fused.tiled"]
             + n_fmt["dpa_matmul_fused.tiled"],
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
         "launches": n_d["dpa_act_quant"] + n_rec["dpa_act_quant"]
         + n_fam["dpa_act_quant"] + n_fmt["dpa_act_quant"],
         "max_abs_err": 0.0, **times(tl_t["prepass"]),
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no PyTorch call quantizes per (row, K block of "
                    "128) with the contract's scale in one pass",
         "at": "path D: one qwen3-4b layer's 7 projections' activations at "
               "M=4096, bf16 -> E4M3 codes and block scales"},
        {"name": "paged_decode_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/paged_decode.cu",
         "replaces": "src/repro/kernels/flash_attention.py:332",
         "launches": n_serve["paged_decode_attention"]
         + n_tp["paged_decode_attention"] + n_fmt["paged_decode_attention"],
         "tp_launches": n_tp["paged_decode_attention"],
         "path_m": paged_m,
         "max_abs_err": max(pd_err, gpd_err), **times(pd_t),
         "bound_by": pd_t["bound_by"], "library_ms": None,
         "split": pd_t["split"], "splits_device_ms": pd_t["splits_device_ms"],
         "long": pd_t["long"],
         "launches_by_format": {
             f: every[f"paged_decode_attention.{f}"]
             for f in ("fp8_e4m3", "fp32") + PAGED_NEW_ATTN},
         "formats": {"hd128": pdf_t, "hd64": gpdf_t},
         "tuner": tuned("cuda_block_table"),
         "verify_fold": {"launches": n_serve["paged_decode_attention.verify"],
                         "hd128": fold_t, "hd64": gfold_t,
                         "at": f"B=4, k={VERIFY_K}: {4 * (VERIFY_K + 1)} "
                               "rows in one launch at the decode split; "
                               "plain: the verify fold's plain version"},
         "at": "one layer, B=4 H=32 KV=8 hd=128 page=16 lengths "
               "[256,201,101,18], fp8 attention over packed fp4 (formats: "
               "fp4 and fp16 attention over packed fp4 and E4M3 KV, fp8 "
               "over E4M3); long: B=2, 2048 pages of 16, positions "
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
         "tuner": tuned("cuda_prequant"),
         "formats": pqf_t["dense"],
         "oracle_outputs": {k: v for k, v in pqo_t.items()
                            if k.endswith("E=1")},
         "at": "granite-moe-1b, one layer's 4 attention projections at "
               "M=8 (2 rows padded), packed E2M1 x packed E2M1 (formats: "
               "the same layer in each new operand format, timed warm)"},
        {"name": "dpa_grouped_matmul_fused", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_matmul.cu",
         "replaces": "src/repro/kernels/dpa_grouped_matmul.py:154",
         "launches": n_g["dpa_grouped_matmul_fused"]
         + n_fmt["dpa_grouped_matmul_fused"],
         "splitk_launches": n_g["dpa_grouped_matmul_fused.splitk"]
         + n_fmt["dpa_grouped_matmul_fused.splitk"],
         "launches_by_x_format": {
             f: every[f"dpa_grouped_matmul_fused.{f}"]
             for f in FUSED_X_FMTS},
         "max_abs_err": gf_err, **times(gf_t),
         "bound_by": "bytes", "library_ms": None,
         "cold": gf_t["cold"], "plans": gf_t["plans"],
         "tuner": tuned("cuda_grouped_fused"),
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
         "tuner": tuned("cuda_grouped_prequant"),
         "formats": pqf_t["grouped"],
         "oracle_outputs": {k: v for k, v in pqo_t.items()
                            if not k.endswith("E=1")},
         "at": "granite-moe-1b, one layer's 3 expert matmuls (E=32) at "
               "M=8 (2 rows padded), packed E2M1 x packed E2M1 (formats: "
               "the same layer in each new operand format, timed warm)"},
        {"name": "dpa_flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/dpa_flash.cu",
         "replaces": "src/repro/kernels/flash_attention.py:218",
         "launches": n_d["dpa_flash_attention"]
         + n_rec["dpa_flash_attention"] + n_fam["dpa_flash_attention"]
         + n_fmt["dpa_flash_attention"],
         "prepass_launches": n_d["dpa_flash_attention.prepass"]
         + n_rec["dpa_flash_attention.prepass"]
         + n_fam["dpa_flash_attention.prepass"]
         + n_fmt["dpa_flash_attention.prepass"],
         "formats": dff_t,
         "path_n": {k: unprofiled(v) for k, v in flash_n.items()},
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
         "tuner": tuned("cuda_dpa_flash"),
         "p_codes_flipped": dfa_t["flips"],
         "path_d_p_codes_flipped_per_layer":
             score_d["attn_p_codes_flipped_per_layer"],
         "at": "one layer of qwen3-4b scoring: B=1 S=4096 H=32 KV=8 hd=128 "
               "causal, bf16, raw K/V on the fp4 grid, pre-pass included "
               "(bound at the fp8 peak)",
         "hd256": {**times(wide_t), "bound_by": wide_t["bound_by"],
                   "device_from": wide_t.get("device_from"),
                   "max_abs_err": wide_t["max_abs_err"],
                   "fp16_bound_ms": wide_t["fp16_bound_ms"],
                   "band_pairs_per_head": wide_t["band_pairs_per_head"],
                   "prepass_ms": wide_t["prepass_ms"],
                   "prepass_device_ms": wide_t["prepass_device_ms"],
                   "p_codes_flipped": wide_t["flips"],
                   "launches": n_rec["dpa_flash_attention"],
                   "path_h_p_codes_flipped_per_layer": rec[
                       "recurrentgemma-9b"]["prefill"][
                       "attn_p_codes_flipped_per_layer"],
                   "at": "path H: one recurrentgemma-9b local attention "
                         "layer, B=1 S=4096 H=16 KV=1 hd=256 window 2048 "
                         "causal, bf16, raw K/V on the fp4 grid, bq 64 bk "
                         "128, pre-pass included (bound: the band's live "
                         "pairs at the fp8 peak)"},
         "families": {
             "launches": n_fam["dpa_flash_attention"],
             "whisper-medium encoder (non-causal, Sq = Sk = 1500, bq = bk "
             "= 125, hd 64)": fam["whisper-medium"]["encoder_attention"],
             "whisper-medium cross-attention (Sq 32 x Sk 1500, bq 32, bk "
             "125, hd 64)": fam["whisper-medium"]["cross_attention"],
             "pixtral-12b scoring (causal, S 4096, hd 128)":
                 fam["pixtral-12b"]["attention"]}},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:100",
         "launches": n_c["flash_attention"] + n_fam["flash_attention"]
         + n_fmt["flash_attention"],
         "max_abs_err": fa_t["max_abs_err"], **times(fa_t),
         "device_from": fa_t.get("device_from"),
         "bound_by": fa_t["bound_by"], **lib(fa_t),
         "f32_bound_ms": fa_t["f32_bound_ms"],
         "speed_references": fa_t["speed_references"],
         "tuner": tuned("cuda_f32_flash"),
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
                       "products at the bf16 peak)"},
         "families": {
             "launches": n_fam["flash_attention"],
             "whisper-medium encoder under fp8_dpa (bf16, non-causal, Sq = "
             "Sk = 1500, bq = bk = 125, hd 64), max |diff| vs plain":
                 fam["whisper-medium"]["encode_fp8_dpa"][
                     "attn_max_abs_err_vs_plain"]}},
        {"name": "quantize_rows", "route": "cuda",
         "source": "src/repro_torch/csrc/quantize_rows.cu",
         "replaces": "src/repro/kernels/quantize.py:70",
         "launches": n_qp["quantize_rows"] + n_fmt["quantize_rows"],
         "max_abs_err": 0.0, **times(qz_t["quantize_rows"]),
         "device_from": qz_t["quantize_rows"]["device_from"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: no PyTorch call computes per-row absmax scales "
                    "and the saturating cast in one pass",
         "plan": qz_t["quantize_rows"]["plan"],
         "tuner": tuned("cuda_quantize_rows"),
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
         "launches": n_qp["quantize_pack_rows"] + n_d["quantize_pack_rows"]
         + n_rec["quantize_pack_rows"]
         + n_fam["quantize_pack_rows"] + n_fmt["quantize_pack_rows"],
         "max_abs_err": 0.0, **times(qz_t["quantize_pack_rows"]),
         "device_from": qz_t["quantize_pack_rows"]["device_from"],
         "bound_by": "bytes", "library_ms": None,
         "library": "none: PyTorch has no E2M1 encode or nibble pack",
         "plan": qz_t["quantize_pack_rows"]["plan"],
         "tuner": tuned("cuda_quantize_pack"),
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
        {"qwen3-4b": rep_q, "granite-moe-1b-a400m": rep_g,
         "qwen3-4b sampled": rep_s, "qwen3-4b prefix cache": rep_p,
         "qwen3-4b front end": rep_f, "qwen3-4b speculative": rep_j,
         "qwen3-4b adaptive front end": rep_fa}))
    print("generate: " + json.dumps(
        {"granite-moe-1b-a400m fp4_dpa_packed": gen_b}))
    print("prefill and scoring: " + json.dumps(
        {"qwen3-4b prefill fp8_dpa use_flash S=4096": pre_c,
         "qwen3-4b scoring w4a8_kv4_attn8 use_flash S=4096": score_d}))
    print("formats: " + json.dumps(
        {"path L": {"qwen3-4b generate": gen_lq, "qwen3-4b scoring": score_l,
                    "granite-moe-1b generate": gen_lg},
         "path M": paged_m, "path N": flash_n, "fused": ff_t,
         "dpa flash": dff_t}))
    print("profile: " + json.dumps(
        {"qwen3-4b": prof_q, "granite-moe-1b-a400m": prof_g}))
    serving_summary({"qwen3-4b": (rep_q, prof_q),
                     "granite-moe-1b-a400m": (rep_g, prof_g)}, gen_b)
    sampled_summary(rep_q, prof_q, rep_s, rep_p, rep_f)
    for name, r in rep_j.items():
        if "step_profiles" in r:
            print("summary qwen3-4b " + _spec_line(name, r, rep_q,
                                                   r["step_profiles"]))
    print("recurrent: " + json.dumps(rec))
    for name, r in rec.items():
        g = r["generate"]
        print(f"summary {name} generate: graphed tokens equal eager "
              f"{g['tokens_equal_eager']}, {g['tokens_per_s']:.1f} tokens/s "
              f"graphed ({g['eager']['tokens_per_s']:.1f} eager), decode "
              f"step device {g['profile']['graphed']['busy_ms']} ms, peak "
              f"{r['peak_gb']:.2f} GB")
    print("families: " + json.dumps(fam))
    for name, r in fam.items():
        print(f"summary {name}: path {r['seconds']:.1f} s, peak "
              f"{r['peak_gb']:.2f} GB, " + ", ".join(
                  f"{k} {v['wall_s'] * 1e3:.1f} ms"
                  for k, v in r.items() if isinstance(v, dict)
                  and "wall_s" in v))
    print("train: " + json.dumps(train))
    print("tp: " + json.dumps(tp))
    print("roofline: " + json.dumps(ROOFLINE))
    print("datapath: " + json.dumps({"seconds": t_dp, **dp_t,
                                     "prequant_vs_oracle": pqo_t}))
    print("tuner: " + json.dumps({**{k: v for k, v in tune.items()
                                     if k != "table"},
                                  "engine": rep_q["tuned"]}))
    print(f"total {t_total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
