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
            With the prefix cache on (`EngineConfig.prefix_cache`),
            admission first matches the prompt against the radix index
            (`serving.prefix_cache`): fully matched pages are shared
            read-only into the block table (allocator refcounts keep
            them alive), a partial-page match is copied into a private
            page (copy-on-write), only the rest is allocated fresh, and
            cold cached prefixes are evicted LRU under pool pressure.
  prefill : the prompt runs in fixed-size chunks against a contiguous
            (1, S_max) staging cache, then the staged rows scatter into
            the request's pages (`write_prefill_rows`, pure relayout).
            The last chunk's logits give the first generated token.  A
            prefix hit first loads its matched rows from its pages into
            staging (pure relayout) and prefills only from the
            divergence point, with one short chunk to realign to the
            chunk grid; after the scatter its full-prompt pages join the
            index.  Shared pages hold exactly the codes a cold prefill
            writes, so warm tokens equal cold tokens bit for bit.
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
the decode step with its token choice inside (`serving.sampler`:
greedy, or sampled on each request's threefry stream keyed on (seed,
rid, position), read from the step's rids and positions buffers), as
the reference's `_make_decode_step`, and the prefill chunk.  On the
card each is captured once, at construction, as a CUDA graph (the
reference jits both) and replayed with its inputs copied into the
buffers; the decode step brings its B tokens back through one pinned
buffer, its one host sync.  `graphs=False`, and the CPU always, run the
same functions eagerly.  The scheduler stays on the host, as the
reference's.

Sampled tokens depend on (seed, rid, position, role) alone, never on a
slot, the batch or a host generator (whose state a capture would
freeze).  Greedy outputs equal `launch.serve.generate` token for token
per request on the CPU, where every plain path is row-invariant
(`core.device.rowwise_dot`) — for a MoE model with `prefill_chunk=1`,
since expert capacity is computed per model call.  MoE configs serve
through the `grouped_matmul` plan, resolved at construction.
Speculative decoding, the adaptive draft ladder and tensor parallelism
are later slices of the port (ROADMAP Queue 1: "Speculative decoding and
the adaptive draft ladder", "Tensor-parallel serving and
collectives").
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
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serving.sampler import (SamplerConfig, greedy_tokens,
                                         sample_tokens)

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
    prefix_cache: bool = False   # share prompt prefixes across requests

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
    prefill_skip: int = 0        # prompt tokens covered by a prefix hit
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
                       gen_range=(4, 16), shared_prefix: int = 0,
                       mixed: float = 0.0) -> List[Request]:
    """Open-loop synthetic traffic: Poisson arrivals at `rate` req/s
    (0: all at t=0), prompt and output lengths uniform over the inclusive
    ranges — the reference's numpy stream, draw for draw.

    `shared_prefix` > 0 prepends the same drawn tokens to every prompt (a
    system prompt, the prefix cache's workload).  `mixed` > 0 makes each
    request, with that probability, a long one (prompt over [2, 4] x the
    top of `prompt_range`, gen likewise), every draw of that class from a
    forked stream keyed (seed, 1), so `mixed=0` leaves the base stream as
    it was."""
    rng = np.random.default_rng(seed)
    hetero = np.random.default_rng([seed, 1]) if mixed > 0 else None
    arrivals = np.cumsum(rng.exponential(1.0 / rate, n_requests)) \
        if rate > 0 else np.zeros(n_requests)
    prefix = (rng.integers(0, vocab, size=shared_prefix).astype(np.int32)
              if shared_prefix > 0 else None)
    reqs = []
    for i in range(n_requests):
        if hetero is not None and hetero.random() < mixed:
            s0 = int(hetero.integers(2 * prompt_range[1],
                                     4 * prompt_range[1] + 1))
            gen = int(hetero.integers(2 * gen_range[1],
                                      4 * gen_range[1] + 1))
            prompt = hetero.integers(0, vocab, size=s0).astype(np.int32)
        else:
            s0 = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
            gen = int(rng.integers(gen_range[0], gen_range[1] + 1))
            prompt = rng.integers(0, vocab, size=s0).astype(np.int32)
        if prefix is not None:
            prompt = np.concatenate([prefix, prompt])
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
        self.prefix = (PrefixCache(ecfg.page_size, self.alloc)
                       if ecfg.prefix_cache else None)
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
        self.prefix_queries = 0
        self.prefix_hits = 0
        self.prefill_tokens_saved = 0
        self.cow_copies = 0
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
        either graph (one pool): each step reads its own at once.

        The decode step draws each slot's token at timeline index
        positions + 1 on its request's stream (rids); a greedy sampler
        reads neither, so its graph holds the argmax alone, as before
        sampling joined the port."""
        e, dev, model, params = self.ecfg, self.device, self.model, \
            self.params
        scfg = self.sampler

        def decode(tokens, positions, block_table, rids):
            # block_table is the table every layer's pool holds
            logits, _ = model.decode_step(
                params, {"tokens": tokens, "index": positions}, self.caches)
            if scfg.greedy:
                return greedy_tokens(logits[:, -1])
            return sample_tokens(logits[:, -1], rids, positions + 1, scfg)

        def prefill(tokens, index):
            logits, _ = model.decode_step(
                params, {"tokens": tokens, "index": index}, self._staging)
            return logits

        steps = (("decode step", decode, dict(
                    tokens=torch.zeros((e.max_batch, 1), dtype=torch.int64,
                                       device=dev),
                    positions=torch.zeros((e.max_batch,), dtype=torch.int32,
                                          device=dev),
                    block_table=self._block_table,
                    rids=torch.zeros((e.max_batch,), dtype=torch.int32,
                                     device=dev))),
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
        layer (pure relayout).  A prefix hit scatters from its divergence
        point on: rows before `prefill_skip` live in shared (or
        copied-on-write) pages that must not be written."""
        for pool, staged in zip(self.caches, self._staging):
            rows = {k: staged[k][0] for k in KV.QUANT_KEYS}
            KV.write_prefill_rows(pool, rows, req.pages, req.n_prompt,
                                  start=req.prefill_skip)

    def _cow_copy(self, src: int, dst: int, n_rows: int):
        """Copy the first `n_rows` rows of pool page `src` into the private
        page `dst`, every layer, in place (pure relayout: the graphs read
        the pools at fixed addresses).  The shared source is only read."""
        for pool in self.caches:
            for k in KV.QUANT_KEYS:
                pool[k][dst, :n_rows].copy_(pool[k][src, :n_rows])
        self.cow_copies += 1

    def _load_prefix_to_staging(self, req: Request):
        """Copy the matched rows [0, prefill_skip) from the request's pages
        into the staging cache, in place (the inverse relayout of the
        scatter), so the warm prefill's chunks attend over exactly the
        codes and scales a cold prefill of the same prompt would have
        staged."""
        m = req.prefill_skip
        for pool, staged in zip(self.caches, self._staging):
            rows = KV.gather_page_rows(pool, req.pages, m)
            for k in KV.QUANT_KEYS:
                staged[k][0, :m].copy_(rows[k])

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

    def _match_prefix(self, req: Request) -> Optional[PrefixMatch]:
        """Match and pin: look the prompt up in the prefix index and take a
        request reference on every matched page (the shared full pages
        and the copy-on-write source) before any eviction runs (a page
        only the cache holds sits at refcount 1 and must not be reclaimed
        between the match and its use), then evict cold cached prefixes
        LRU to cover the allocation shortfall."""
        if self.prefix is None:
            return None
        e = self.ecfg
        # at least one prompt token must prefill (its logits give the
        # first token), and the warm start's fixed chunk window must fit
        # inside the staging cache
        limit = min(req.n_prompt - 1, e.s_max - e.prefill_chunk)
        m = self.prefix.match(req.prompt, limit)
        self.alloc.incref(m.pages)
        if m.cow is not None:
            self.alloc.incref([m.cow[0]])
        short = (self._pages_needed(req) - len(m.pages)
                 - self.alloc.n_available)
        if short > 0:
            self.prefix.evict(short)
        return m

    def _unpin_match(self, m: PrefixMatch):
        """Drop the references `_match_prefix` took (admission did not go
        through); the pages stay resident under the cache's own."""
        self.alloc.free(m.pages)
        if m.cow is not None:
            self.alloc.free([m.cow[0]])

    def _admit(self, now: float):
        for slot in range(self.ecfg.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting[0]
            n_pages = self._pages_needed(req)
            match = self._match_prefix(req)     # pins matched pages
            shared = list(match.pages) if match is not None else []
            fresh = n_pages - len(shared)
            if not self.alloc.can_alloc(fresh):
                if match is not None:
                    self._unpin_match(match)
                break                      # FIFO: don't starve the head
            self.waiting.pop(0)
            req.pages = shared + self.alloc.alloc(fresh)
            if match is not None:
                # admissions, not retries: a request that waited several
                # ticks for pages is one query
                self.prefix_queries += 1
                req.prefill_skip = req.prefill_done = match.tokens
                self.prefix_hits += match.tokens > 0
                self.prefill_tokens_saved += match.tokens
                if match.cow is not None:
                    src, rows = match.cow
                    # copy while the source pin is held, then drop it
                    self._cow_copy(src, req.pages[len(shared)], rows)
                    self.alloc.free([src])
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
        if req.prefill_skip > 0 and c0 == req.prefill_skip:
            # a prefix hit's first chunk: its matched rows into staging
            self._load_prefix_to_staging(req)
        n = min(e.prefill_chunk, req.n_prompt - c0)
        if c0 % e.prefill_chunk:
            # realign a warm start to the chunk grid with one short chunk,
            # so every later fixed-size window stays inside the staging
            # cache (rows are quantized before attention: chunk splits do
            # not change numerics)
            n = min(n, e.prefill_chunk - c0 % e.prefill_chunk)
        chunk = np.zeros((1, e.prefill_chunk), np.int64)
        chunk[0, :n] = req.prompt[c0:c0 + n]
        logits = self._prefill(tokens=chunk, index=c0)
        self.n_prefill_calls += 1
        req.prefill_done += n
        if req.prefill_done == req.n_prompt:
            self._scatter_staging_to_pages(req)
            self._table[req.slot, :len(req.pages)] = req.pages
            self._tables_dirty = True
            if self.prefix is not None:
                # only now do the pages hold the prompt's rows
                self.prefix.insert(req.prompt, req.pages)
            # the first generated token sits at timeline index n_prompt
            row = logits[:, n - 1]
            first = int(greedy_tokens(row)[0] if self.sampler.greedy else
                        sample_tokens(row, self._host_ids(req.rid),
                                      self._host_ids(req.n_prompt),
                                      self.sampler)[0])
            req.out_tokens.append(first)
            req.pos = req.n_prompt
            req.state, req.t_first = DECODE, now
            self._maybe_finish(req, first, now)
        return n

    def _host_ids(self, value: int):
        """(1,) int32 device tensor of one id, filled on the device."""
        return torch.full((1,), value, dtype=torch.int32,
                          device=self.device)

    def _decode_batch(self, now: float) -> int:
        """One batched decode step over every DECODE-state slot."""
        e = self.ecfg
        live = [r for r in self.slots if r is not None and r.state == DECODE]
        if not live:
            return 0
        tokens = np.zeros((e.max_batch, 1), np.int64)
        positions = np.zeros((e.max_batch,), np.int32)
        rids = np.zeros((e.max_batch,), np.int32)
        for r in live:
            tokens[r.slot, 0] = r.out_tokens[-1]
            positions[r.slot] = r.pos
            rids[r.slot] = r.rid
        inputs = dict(tokens=tokens, positions=positions)
        if not self.sampler.greedy:
            inputs["rids"] = rids
        nxt = self._decode(**inputs)
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
            # cache until its prompt is fully staged (a prefix hit starts
            # at prefill_skip, so "untouched" is done == skip); ties on
            # t_admit break by admission order (rid)
            budget -= self._prefill_step(
                min(pre, key=lambda r: (r.prefill_done == r.prefill_skip,
                                        r.t_admit, r.rid)), now)
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
            # the port has no tuned table: resolution is the priority scan
            "decode_selection": "prior",
            "decode_bytes_per_step_layer": self.plan["bytes_moved"],
            "temperature": self.sampler.temperature,
            "device": str(self.device),
            "graphs": self.graphed,
            **self.kv_bytes_report(),
        }
        if self.graphed:
            rep["capture"] = {step.name: step.stats
                              for step in (self._decode, self._prefill)}
        if self.prefix is not None:
            rep.update(self.prefix_report())
        if self.cfg.is_moe:
            rep.update(self.moe_report())
        return rep

    def prefix_report(self) -> dict:
        """Prefix-cache hits, prefill tokens skipped, copy-on-write copies,
        and what keeping the resident prefixes costs at format width."""
        e, cfg, pol = self.ecfg, self.cfg, self.pol
        resident = KV.paged_kv_cache_nbytes(
            0, self.prefix.n_pages, e.page_size, cfg.n_kv_heads, cfg.hd,
            fmt=pol.fmt_kv, packed=pol.kv_packed)
        return {
            "prefix_queries": self.prefix_queries,
            "prefix_hits": self.prefix_hits,
            "prefix_hit_rate": (self.prefix_hits / self.prefix_queries
                                if self.prefix_queries else 0.0),
            "prefill_tokens_saved": self.prefill_tokens_saved,
            "prefix_cow_copies": self.cow_copies,
            "resident_prefix_pages": self.prefix.n_pages,
            "resident_prefix_bytes": resident["paged"] * cfg.n_layers,
        }

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


def format_report(rep: dict, policy: str) -> str:
    """The front end's report lines (the reference's `format_report` for
    the keys the port reports): throughput and latency, cache bytes from
    actual per-request lengths and page use, the decode plan, and the
    prefix-cache and MoE lines where the report has them."""
    mb = 1e6
    return (
        f"engine: {rep['n_requests']} reqs, {rep['gen_tokens']} tokens in "
        f"{rep['wall_s']:.2f}s ({rep['tokens_per_s']:.1f} tok/s, "
        f"{rep['steps']} steps, policy={policy})\n"
        f"latency: p50 {rep['p50_latency_s'] * 1e3:.0f} ms, "
        f"p99 {rep['p99_latency_s'] * 1e3:.0f} ms, "
        f"ttft p50 {rep['p50_ttft_s'] * 1e3:.0f} ms\n"
        f"kv-cache: peak live {rep['live_bytes'] / mb:.2f} MB "
        f"({rep['peak_live_tokens']} tokens) in "
        f"{rep['paged_bytes'] / mb:.2f} MB of pages vs static "
        f"{rep['static_bytes'] / mb:.2f} MB (B x S_max, same format) / "
        f"f32 {rep['static_f32_bytes'] / mb:.2f} MB; "
        f"page util peak {rep['page_util']:.0%} "
        f"({rep['pages_peak']}/{rep['pages_total']} pages)\n"
        f"plan: decode via {rep['decode_route']} "
        f"[{rep['decode_backend']}, {rep['decode_selection']}], "
        f"{rep['decode_bytes_per_step_layer'] / 1e3:.1f} KB KV moved "
        "per step/layer"
        + (f"\nprefix: {rep['prefix_hits']}/{rep['prefix_queries']} hits "
           f"({rep['prefix_hit_rate']:.0%}), "
           f"{rep['prefill_tokens_saved']} prefill tokens saved, "
           f"{rep['prefix_cow_copies']} CoW copies; "
           f"{rep['resident_prefix_pages']} resident pages "
           f"({rep['resident_prefix_bytes'] / mb:.2f} MB at format width)"
           if "prefix_hit_rate" in rep else "")
        + (f"\nmoe: {rep['moe_experts']} experts top-{rep['moe_top_k']}, "
           f"grouped via {rep['moe_grouped_route']} "
           f"[{rep['moe_grouped_backend']}, "
           f"{rep['moe_grouped_selection']}]; expert weights "
           f"{rep['expert_w_bytes'] / mb:.2f} MB at format width vs f32 "
           f"{rep['expert_w_bytes_f32'] / mb:.2f} MB "
           f"({rep['expert_w_reduction_vs_f32']:.1f}x), "
           f"{rep['moe_grouped_bytes_per_step_layer'] / 1e3:.1f} KB "
           "expert operands per step/layer"
           if "moe_experts" in rep else ""))
