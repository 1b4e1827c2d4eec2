"""Continuous-batching serving engine over the paged quantized KV cache
(port of the core lifecycle of `repro.launch.engine`).

Cache storage is a pool of fixed-size pages shared by every live request
through per-request block tables, so cache memory scales with live
tokens, and one fixed-shape decode step serves requests at different
positions (per-request rope and mask via a position vector).

Request lifecycle — admit -> prefill -> decode -> finish/evict:

  admit   : a waiting request takes a free decode slot when the
            `PageAllocator` can hand it ceil((prompt + max_new) / page)
            pages (full reservation: no request runs out mid-decode).
  prefill : the prompt runs in fixed-size chunks against a contiguous
            (1, S_max) staging cache, then the staged rows scatter into
            the request's pages (`write_prefill_rows`, pure relayout).
            The last chunk's logits give the first generated token.
  decode  : every running request steps in one fixed-shape batch; each
            slot writes its token into its own page and attends through
            its block-table row via the ``paged_decode`` route (the CUDA
            block-table kernel on the card).  Idle slots point at the
            scratch page.
  finish  : at max_new (or eos) the pages return to the free list and
            the table row resets to scratch.

The scheduler is token-budgeted: each step spends one token per running
decode request first, the remainder on prefill chunks of the oldest
admitted request.

Both steps are functions over static device buffers (`launch.graphs`):
the decode step with its greedy token choice inside, as the reference's
`_make_decode_step`, and the prefill chunk.  On the card each is
captured once, at construction, as a CUDA graph (the reference jits
both) and replayed with its inputs copied into the buffers; the decode
step brings its B tokens back through one pinned buffer, its one host
sync.  `graphs=False`, and the CPU always, run the same functions
eagerly.  The scheduler stays on the host, as the reference's.

Greedy outputs equal `launch.serve.generate` token for token per request
on the CPU, where every plain path is row-invariant
(`core.device.rowwise_dot`) — for a MoE model with `prefill_chunk=1`,
since expert capacity is computed per model call.  MoE configs serve
through the `grouped_matmul` plan, resolved at construction.
Speculative decoding, the adaptive draft ladder, the prefix cache and
tensor parallelism are later slices of the port (ROADMAP Queue 1:
"Speculative decoding and the adaptive draft ladder", "Prefix caching",
"Tensor-parallel serving and collectives").
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import exec_plan
from repro_torch.core import kvcache as KV
from repro_torch.core.device import resolve_device
from repro_torch.core.packing import operand_nbytes
from repro_torch.core.policy import get_policy
from repro_torch.launch.graphs import Step, StepGraph
from repro_torch.serving.sampler import SamplerConfig, greedy_tokens

WAITING, PREFILL, DECODE, FINISHED = "waiting", "prefill", "decode", "done"


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine geometry + scheduler knobs.  S_max per request =
    max_pages_per_req * page_size."""
    page_size: int = 16
    n_pages: int = 64            # pool capacity (page 0 is scratch)
    max_batch: int = 4           # concurrent decode slots
    max_pages_per_req: int = 8   # block-table width
    token_budget: int = 16       # tokens per scheduler step
    prefill_chunk: int = 8       # prompt tokens per prefill call
    eos_id: int = -1             # stop token (-1: run to max_new)

    @property
    def s_max(self) -> int:
        return self.max_pages_per_req * self.page_size


@dataclasses.dataclass
class Request:
    """One serving request plus its lifecycle/accounting state."""
    rid: int
    prompt: np.ndarray           # (S0,) int32 token ids
    max_new: int
    arrival: float = 0.0         # seconds after engine start (open loop)
    state: str = WAITING
    out_tokens: list = dataclasses.field(default_factory=list)
    pages: list = dataclasses.field(default_factory=list)
    slot: int = -1
    pos: int = 0                 # tokens written to the cache so far
    prefill_done: int = 0
    t_admit: float = 0.0
    t_first: float = 0.0         # first generated token (TTFT anchor)
    t_finish: float = 0.0

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def n_generated(self) -> int:
        return len(self.out_tokens)

    def tokens(self) -> np.ndarray:
        """prompt + generated, the static path's (S0 + max_new,) layout."""
        return np.concatenate([self.prompt,
                               np.asarray(self.out_tokens, np.int32)])


def synthetic_workload(n_requests: int, *, vocab: int, seed: int = 0,
                       rate: float = 0.0, prompt_range=(8, 32),
                       gen_range=(4, 16)) -> List[Request]:
    """Open-loop synthetic traffic: Poisson arrivals at `rate` req/s
    (0: all at t=0), prompt and output lengths uniform over the inclusive
    ranges — the reference's numpy stream, draw for draw."""
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests)) \
        if rate > 0 else np.zeros(n_requests)
    reqs = []
    for i in range(n_requests):
        s0 = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        gen = int(rng.integers(gen_range[0], gen_range[1] + 1))
        prompt = rng.integers(0, vocab, size=s0).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new=gen,
                            arrival=float(arrivals[i])))
    return reqs


class Engine:
    """Continuous-batching engine bound to one model + params, on
    `device` (default "cuda", which must be where the model lives); its
    steps run as CUDA graphs there unless `graphs=False`."""

    def __init__(self, model, params, ecfg: EngineConfig, *,
                 sampler: Optional[SamplerConfig] = None, device=None,
                 graphs: bool = True):
        dev = resolve_device(device)
        if dev.type != model.device.type:
            raise ValueError(f"model lives on {model.device}, not {dev}")
        cfg = model.cfg
        pol = get_policy(cfg.policy)
        self.sampler = sampler or SamplerConfig()
        if not self.sampler.greedy:
            raise NotImplementedError(
                "sampled decoding needs per-request threefry streams "
                "(ROADMAP Queue 1, \"Sampled decoding and the serving "
                "front end\"); the port serves greedy")
        self._plan_ctx = dict(batch=ecfg.max_batch, page_size=ecfg.page_size,
                              max_pages=ecfg.max_pages_per_req,
                              kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                              n_pages=ecfg.n_pages)
        try:
            self.plan = exec_plan.describe("paged_decode", pol,
                                           **self._plan_ctx)
        except exec_plan.PlanError as e:
            raise ValueError(
                f"policy {cfg.policy!r} keeps a raw f32 cache; the paged "
                "engine stores format-width codes — pick a fmt_kv preset "
                "(e.g. kv8_attn_f32 for f32 arithmetic over an fp8 cache)"
            ) from e
        # MoE configs serve through the grouped_matmul plan, stated at the
        # decode step's dispatch shape: each batch row buffers its single
        # token into (B, E, C, d) with C = f(S=1)
        self.moe_plan, self._moe_ctx = None, None
        if cfg.is_moe:
            c = int(cfg.capacity_factor * cfg.top_k / cfg.n_experts) + 1
            self._moe_ctx = dict(w_dtype="float32", eq="becd,edf->becf",
                                 e=cfg.n_experts, m=ecfg.max_batch * c,
                                 k=cfg.d_model, n=cfg.d_ff)
            self.moe_plan = exec_plan.describe("grouped_matmul", pol,
                                               **self._moe_ctx)
        if ecfg.s_max % ecfg.prefill_chunk:
            raise ValueError(f"S_max ({ecfg.s_max}) must be a multiple of "
                             f"prefill_chunk ({ecfg.prefill_chunk})")
        self.model, self.params, self.ecfg = model, params, ecfg
        self.cfg, self.pol, self.device = cfg, pol, model.device
        self.alloc = KV.PageAllocator(ecfg.n_pages)
        self._table = np.full((ecfg.max_batch, ecfg.max_pages_per_req),
                              KV.SCRATCH_PAGE, np.int32)
        # one device block table, shared by every layer's pool (a
        # request's page ids index every layer's pool)
        self._block_table = torch.from_numpy(self._table.copy()).to(
            self.device)
        self.caches = [
            dict(KV.init_paged_kv_cache(ecfg.n_pages, ecfg.page_size,
                                        cfg.n_kv_heads, cfg.hd,
                                        fmt=pol.fmt_kv, packed=pol.kv_packed,
                                        device=self.device),
                 block_table=self._block_table)
            for _ in range(cfg.n_layers)]
        # staging cache for chunked prefill: the contiguous layout
        self._staging = model.init_caches(1, ecfg.s_max)
        self.slots: List[Optional[Request]] = [None] * ecfg.max_batch
        self.waiting: List[Request] = []
        self.finished: List[Request] = []
        self._tables_dirty = False
        self.peak_live_tokens = 0
        self.n_steps = 0
        self.n_prefill_calls = 0
        self.n_decode_steps = 0
        self.graphed = graphs and self.device.type == "cuda"
        self._tok_host = torch.empty((ecfg.max_batch,), dtype=torch.int32,
                                     pin_memory=self.device.type == "cuda")
        self._decode, self._prefill = self._make_steps()

    def _make_steps(self):
        """-> (decode step, prefill chunk) over static device buffers.

        On the card with graphs both are captured here, into one memory
        pool, while every slot is idle and every block-table row is
        scratch: their warm-up calls write only the scratch page (the
        decode step, positions 0) and staging rows [0, prefill_chunk)
        (the prefill chunk, index 0), which the first real chunk
        overwrites.  A graph's outputs hold until the next replay of
        either graph (one pool): each step reads its own at once."""
        e, dev, model, params = self.ecfg, self.device, self.model, \
            self.params

        def decode(tokens, positions, block_table):
            # block_table is the table every layer's pool holds
            logits, _ = model.decode_step(
                params, {"tokens": tokens, "index": positions}, self.caches)
            return greedy_tokens(logits[:, -1])

        def prefill(tokens, index):
            logits, _ = model.decode_step(
                params, {"tokens": tokens, "index": index}, self._staging)
            return logits

        steps = (("decode step", decode, dict(
                    tokens=torch.zeros((e.max_batch, 1), dtype=torch.int64,
                                       device=dev),
                    positions=torch.zeros((e.max_batch,), dtype=torch.int32,
                                          device=dev),
                    block_table=self._block_table)),
                 ("prefill chunk", prefill, dict(
                    tokens=torch.zeros((1, e.prefill_chunk),
                                       dtype=torch.int64, device=dev),
                    index=torch.zeros((), dtype=torch.int32, device=dev))))
        if not self.graphed:
            return tuple(Step(fn, bufs, name=name)
                         for name, fn, bufs in steps)
        pool = torch.cuda.graph_pool_handle()
        return tuple(StepGraph(fn, bufs, name=name, pool=pool)
                     for name, fn, bufs in steps)

    # -- cache plumbing ----------------------------------------------------

    def _sync_tables(self):
        """Push the host block table into the shared device table."""
        self._decode.load(block_table=self._table)

    def _scatter_staging_to_pages(self, req: Request):
        """Copy the staged prompt rows into the request's pages, every
        layer (pure relayout)."""
        for pool, staged in zip(self.caches, self._staging):
            rows = {k: staged[k][0] for k in KV.QUANT_KEYS}
            KV.write_prefill_rows(pool, rows, req.pages, req.n_prompt)

    # -- lifecycle ---------------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        return -(-(req.n_prompt + req.max_new) // self.ecfg.page_size)

    def submit(self, req: Request):
        e = self.ecfg
        total = req.n_prompt + req.max_new
        if total > e.s_max:
            raise ValueError(f"request {req.rid}: {total} tokens exceed "
                             f"S_max = {e.s_max} (raise max_pages_per_req "
                             "or page_size)")
        if self._pages_needed(req) > self.alloc.capacity - 1:
            raise ValueError(f"request {req.rid} can never fit the pool")
        req.state = WAITING
        self.waiting.append(req)

    def _admit(self, now: float):
        for slot in range(self.ecfg.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            n_pages = self._pages_needed(req)
            if not self.alloc.can_alloc(n_pages):
                break                      # FIFO: don't starve the head
            self.waiting.pop(0)
            req.pages = self.alloc.alloc(n_pages)
            req.slot, req.state, req.t_admit = slot, PREFILL, now
            self.slots[slot] = req
            # the table row stays scratch until prefill lands: a PREFILL
            # slot rides decode steps as idle and must not touch its pages

    def _finish(self, req: Request, now: float):
        self.alloc.free(req.pages)
        req.pages = []
        self._table[req.slot] = KV.SCRATCH_PAGE
        self.slots[req.slot] = None
        req.slot = -1
        req.state, req.t_finish = FINISHED, now
        self.finished.append(req)
        self._tables_dirty = True

    def _maybe_finish(self, req: Request, tok: int, now: float):
        if req.n_generated >= req.max_new or tok == self.ecfg.eos_id:
            self._finish(req, now)

    def _prefill_step(self, req: Request, now: float) -> int:
        """Run one prompt chunk; returns real tokens consumed."""
        e = self.ecfg
        c0 = req.prefill_done
        n = min(e.prefill_chunk, req.n_prompt - c0)
        chunk = np.zeros((1, e.prefill_chunk), np.int64)
        chunk[0, :n] = req.prompt[c0:c0 + n]
        logits = self._prefill(tokens=chunk, index=c0)
        self.n_prefill_calls += 1
        req.prefill_done += n
        if req.prefill_done == req.n_prompt:
            self._scatter_staging_to_pages(req)
            self._table[req.slot, :len(req.pages)] = req.pages
            self._tables_dirty = True
            first = int(greedy_tokens(logits[:, n - 1])[0])
            req.out_tokens.append(first)
            req.pos = req.n_prompt
            req.state, req.t_first = DECODE, now
            self._maybe_finish(req, first, now)
        return n

    def _decode_batch(self, now: float) -> int:
        """One batched decode step over every DECODE-state slot."""
        e = self.ecfg
        live = [r for r in self.slots if r is not None and r.state == DECODE]
        if not live:
            return 0
        tokens = np.zeros((e.max_batch, 1), np.int64)
        positions = np.zeros((e.max_batch,), np.int32)
        for r in live:
            tokens[r.slot, 0] = r.out_tokens[-1]
            positions[r.slot] = r.pos
        nxt = self._decode(tokens=tokens, positions=positions)
        self.n_decode_steps += 1
        # the step's one host sync: its B tokens, through a pinned buffer
        self._tok_host.copy_(nxt, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        nxt = self._tok_host.numpy()
        for r in live:
            tok = int(nxt[r.slot])
            r.pos += 1
            r.out_tokens.append(tok)
            self._maybe_finish(r, tok, now)
        return len(live)

    def step(self, now: float = 0.0):
        """One scheduler tick: admit, decode the running batch, spend the
        leftover token budget on prefill chunks."""
        self._admit(now)
        budget = self.ecfg.token_budget - self._decode_batch(now)
        while budget > 0:
            pre = [r for r in self.slots
                   if r is not None and r.state == PREFILL]
            if not pre:
                break
            # a partially prefilled request keeps the (shared) staging
            # cache until its prompt is fully staged; ties on t_admit
            # break by admission order (rid)
            budget -= self._prefill_step(
                min(pre, key=lambda r: (r.prefill_done == 0, r.t_admit,
                                        r.rid)), now)
        self._admit(now)
        if self._tables_dirty:
            self._sync_tables()
            self._tables_dirty = False
        self.peak_live_tokens = max(self.peak_live_tokens,
                                    self.live_tokens())
        self.n_steps += 1

    def live_tokens(self) -> int:
        return sum(r.pos for r in self.slots if r is not None)

    def run(self, requests: List[Request]) -> dict:
        """Serve an open-loop workload to completion; returns `report()`."""
        pending = sorted(requests, key=lambda r: r.arrival)
        t0 = time.monotonic()
        while pending or self.waiting or any(self.slots):
            now = time.monotonic() - t0
            while pending and pending[0].arrival <= now:
                self.submit(pending.pop(0))
            if not self.waiting and not any(self.slots):
                time.sleep(min(0.001, max(0.0, pending[0].arrival - now)))
                continue
            self.step(now)
        return self.report(time.monotonic() - t0)

    # -- accounting --------------------------------------------------------

    def kv_bytes_report(self) -> dict:
        """Cache bytes from actual per-request lengths vs the static
        (B, S_max) baselines."""
        e, cfg, pol = self.ecfg, self.cfg, self.pol
        n_attn = cfg.n_layers
        live = KV.paged_kv_cache_nbytes(
            self.peak_live_tokens, self.alloc.peak_in_use, e.page_size,
            cfg.n_kv_heads, cfg.hd, fmt=pol.fmt_kv, packed=pol.kv_packed)
        static = KV.kv_cache_nbytes(e.max_batch, e.s_max, cfg.n_kv_heads,
                                    cfg.hd, fmt=pol.fmt_kv,
                                    packed=pol.kv_packed)
        return {
            "live_bytes": live["live"] * n_attn,
            "paged_bytes": live["paged"] * n_attn,
            "static_bytes": static["total"] * n_attn,
            "static_f32_bytes": static["f32_total"] * n_attn,
            "peak_live_tokens": self.peak_live_tokens,
            "page_util": self.alloc.peak_in_use / (self.alloc.capacity - 1),
            "pages_peak": self.alloc.peak_in_use,
            "pages_total": self.alloc.capacity - 1,
        }

    def report(self, wall: float) -> dict:
        lat = np.array([r.t_finish - r.arrival for r in self.finished])
        ttft = np.array([r.t_first - r.arrival for r in self.finished])
        gen = sum(r.n_generated for r in self.finished)

        def pct(a, q):
            return float(np.percentile(a, q)) if len(a) else 0.0

        rep = {
            "n_requests": len(self.finished),
            "wall_s": wall,
            "steps": self.n_steps,
            "prefill_calls": self.n_prefill_calls,
            "decode_steps": self.n_decode_steps,
            "gen_tokens": gen,
            "tokens_per_s": gen / wall if wall > 0 else 0.0,
            "p50_latency_s": pct(lat, 50),
            "p99_latency_s": pct(lat, 99),
            "p50_ttft_s": pct(ttft, 50),
            "decode_route": self.plan["route"],
            "decode_backend": self.plan["backend"],
            "decode_bytes_per_step_layer": self.plan["bytes_moved"],
            "device": str(self.device),
            "graphs": self.graphed,
            **self.kv_bytes_report(),
        }
        if self.graphed:
            rep["capture"] = {step.name: step.stats
                              for step in (self._decode, self._prefill)}
        if self.cfg.is_moe:
            rep.update(self.moe_report())
        return rep

    def moe_report(self) -> dict:
        """Which grouped route the expert contraction runs, and the expert
        weights' bytes at format width (all layers x gate/up/down) vs the
        f32 masters' residency."""
        cfg, plan = self.cfg, self.moe_plan
        n_w = cfg.n_layers * 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
        w_bytes = operand_nbytes(n_w, self.pol.fmt_weights,
                                 packed=self.pol.packed)
        return {
            "moe_experts": cfg.n_experts,
            "moe_top_k": cfg.top_k,
            "moe_grouped_route": plan["route"],
            "moe_grouped_backend": plan["backend"],
            # the port has no tuned table: resolution is the priority scan
            "moe_grouped_selection": "prior",
            "moe_grouped_bytes_per_step_layer": plan["bytes_moved"],
            "expert_w_bytes": w_bytes,
            "expert_w_bytes_f32": 4 * n_w,
            "expert_w_reduction_vs_f32": 4 * n_w / w_bytes,
        }
