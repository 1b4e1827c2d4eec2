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

Speculative decoding (`SpecConfig`): the same weights draft k tokens per
request under a cheap low-precision policy, then one batched pass under
the serving policy verifies all k through the ``verify_attn`` route (the
paged decode kernel over B (k+1) rows on the card) and accepts by
rejection sampling (`serving.spec_decode`), so greedy outputs equal the
plain engine's token for token.  Spec mode commits pages lazily out of an
up-front `PageAllocator` reservation (no request runs out mid-decode) and
rolls back pages holding only rejected-draft rows after every round.  The
token budget prices a round at its work: k draft + k+1 verify tokens per
live request.

Adaptive drafting (`runtime.controller.ControllerConfig`): one draft step
per ladder rung, each sharing the params and the page pool
(`validate_policy_pair`), each rung's ``paged_decode`` plan resolved and
its formats checked against the kernel at construction; a pure
per-request feedback controller demotes drafts toward fp4 while the
acceptance EMA stays high and promotes toward fp8/fp16 when it sags.
Each tick batches live requests by current rung and runs one round per
rung group; requests on other rungs ride the fixed-shape batch as ghosts
(their stray writes land at rows >= pos, which their own next round
rewrites before reading, or on the scratch page).  Reservations price the
ladder-wide max draft k, so a rung switch cannot outgrow them.

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
reference's.  In spec mode the steps are each rung's draft step (one
decode step under the rung's policy that appends its token to a device
drafts buffer and advances its own position counter, replayed k times a
round) and one verify step per distinct k (the k+1-token pass with the
accept rule inside), read back once a round: one (emitted, n_accepted)
row a slot.

Sampled tokens depend on (seed, rid, position, role) alone, never on a
slot, the batch or a host generator (whose state a capture would
freeze).  Greedy outputs equal `launch.serve.generate` token for token
per request on the CPU, where every plain path is row-invariant
(`core.device.rowwise_dot`) — for a MoE model with `prefill_chunk=1`,
since expert capacity is computed per model call.  MoE configs serve
through the `grouped_matmul` plan, resolved at construction.  Greedy
speculative and adaptive outputs equal the plain engine's token for token
(on the card too: the verify pass runs its row-count-sensitive
reductions per query row, `models.layers`, and its linears on the fused
kernel's split-K route below `TILED_MIN_M` rows, `check_verify_rows`).
Tensor parallelism (`EngineConfig.tp`, `distributed.tp`): one process
per rank (`launch.mesh.run_ranks`), each running this engine on the same
requests with the group active at construction.  Rank r holds rows [r *
page / tp, (r + 1) * page / tp) of every page of every layer's pool
(`distributed.sharding.cache_placement`); the decode and verify steps
resolve the `*_sharded` routes, which all-gather the pool at format
width (codes and scales: a pure relayout) and run the single-device
route, so tp=N serves tp=1's tokens bit for bit.  Weights stay
replicated, the staging cache is never sharded (prefill stays a
single-rank reduction), and the ranks agree on the clock an open-loop
workload's arrivals are read against.  The engine replicates instead,
with its reason in the report, when page_size % tp != 0 or tp exceeds
the active group's ranks; TP steps run eagerly (graphs=True with tp > 1
on the card is refused: `GRAPHED_TP_ITEM`).

Measured plans (`runtime.tuner`): the engine takes the DB active at its
construction (`exec_plan.use_tuned_db`), resolves its plans and captures
its graphs under it, and makes it the active DB while it steps, so eager
and graphed steps launch the same plans; the report states each plan's
selection, "tuned" or "prior".
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import exec_plan
from repro_torch.core import kvcache as KV
from repro_torch.core.device import resolve_device
from repro_torch.core.packing import operand_nbytes
from repro_torch.core.linear import needs_prep
from repro_torch.core.policy import get_policy
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import tp as TP
from repro_torch.kernels.dpa_matmul import TILED_MIN_M
from repro_torch.kernels.paged_decode import kernel_formats
from repro_torch.launch.graphs import Step, StepGraph
from repro_torch.runtime import controller as CTRL
from repro_torch.runtime.controller import ControllerConfig
from repro_torch.serving import spec_decode as SPD
from repro_torch.serving.prefix_cache import PrefixCache, PrefixMatch
from repro_torch.serving.sampler import (SamplerConfig, greedy_tokens,
                                         sample_tokens)
from repro_torch.serving.spec_decode import SpecConfig

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
    # tensor-parallel width: shard the page pool's within-page rows over
    # the active TP group (`distributed.tp`) and serve through the
    # `*_sharded` routes (tp=1's tokens; the wire carries format-width
    # codes + scales).  Falls back to 1, replicated, never a crash, when
    # tp exceeds the group's ranks or page_size % tp != 0; the report
    # states the reason
    tp: int = 1

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
    reserved_left: int = 0       # reserved-but-uncommitted pages (spec mode)
    rung: int = 0                # current draft-ladder rung (adaptive mode)
    ctrl: object = None          # ControllerState (adaptive mode)
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


MOE_SPEC_ITEM = "ROADMAP Queue 1, \"Speculation on the MoE engine\""
GRAPHED_TP_ITEM = ("ROADMAP Queue 1, \"Graphed TP decode step under NCCL "
                   "(>= 2 cards)\"")
VERIFY_ROWS_ITEM = ("ROADMAP Queue 1, \"Speculative verify beyond the "
                    "split-K route\"")


def check_verify_rows(pol, rows: int) -> None:
    """On the card a verify pass carries the decode steps' bits only where
    the serving policy's linears run the fused kernel's split-K route:
    its row bits do not depend on M below `TILED_MIN_M` rows, where the
    tiled route and cuBLAS pick their order by M.  `rows` is the verify
    pass's M, max_batch (k + 1).  Raises `NotImplementedError` naming the
    ROADMAP item for what lies outside.  Needs no card."""
    route = exec_plan.resolve("matmul", pol, w_dtype="float32").name
    if route != "cuda_fused" or rows >= TILED_MIN_M:
        raise NotImplementedError(
            f"speculative decoding on the card with linears on the "
            f"{route} route at {rows} verify rows: the verify pass keeps "
            f"the decode steps' bits only on cuda_fused below "
            f"{TILED_MIN_M} rows (max_batch * (k + 1)); open in "
            f"{VERIFY_ROWS_ITEM}")


@dataclasses.dataclass
class _Rung:
    """One draft policy: the static spec draft or one adaptive-ladder
    rung.  Its model shares the serving params and page pool; only the
    compute routing and the draft step differ."""
    name: str
    k: int
    pol: object                  # validated TransPrecisionPolicy
    model: object                # the serving model rebuilt under the rung
    plan: dict                   # paged_decode route description
    verify_plan: dict            # verify_attn route at sq = k + 1
    draft: object = None         # Step / StepGraph (`_make_steps`)


class Engine:
    """Continuous-batching engine bound to one model + params, on
    `device` (default "cuda", which must be where the model lives); its
    steps run as CUDA graphs there unless `graphs=False`.

    `sampler` selects the token-draw rule (default greedy argmax); `spec`
    turns on self-speculative decoding (draft under `spec.draft_policy`,
    verify under the model's own policy); `adaptive` replaces the static
    draft policy with a `ControllerConfig` precision ladder walked per
    request by the acceptance-feedback controller.  A draft policy whose
    linears need load-time weights the params lack gets them here
    (`Model.prepare_params`, in place)."""

    def __init__(self, model, params, ecfg: EngineConfig, *,
                 sampler: Optional[SamplerConfig] = None,
                 spec: Optional[SpecConfig] = None,
                 adaptive: Optional[ControllerConfig] = None, device=None,
                 graphs: bool = True):
        if spec is not None and adaptive is not None:
            raise ValueError("pass spec= (one static draft policy) or "
                             "adaptive= (a controller-walked ladder), "
                             "not both")
        dev = resolve_device(device)
        if dev.type != model.device.type:
            raise ValueError(f"model lives on {model.device}, not {dev}")
        cfg = model.cfg
        if set(model.pattern) != {"attn"}:
            raise ValueError(
                f"engine serves uniform-attention decoder stacks; {cfg.name} "
                f"has pattern {model.pattern} (sliding-window/recurrent "
                "blocks keep per-slot state the paged cache does not "
                "model)")
        pol = get_policy(cfg.policy)
        self.tuned_db = exec_plan.tuned_db()
        if (spec is not None or adaptive is not None) and cfg.is_moe:
            raise NotImplementedError(
                f"speculative decoding of a MoE model ({cfg.name}): expert "
                "capacity is computed per model call, so a verify pass "
                "does not carry the decode steps' bits; open in "
                f"{MOE_SPEC_ITEM}")
        self.sampler = sampler or SamplerConfig()
        self._init_tp(ecfg, dev, graphs)
        self._plan_ctx = dict(batch=ecfg.max_batch, page_size=ecfg.page_size,
                              max_pages=ecfg.max_pages_per_req,
                              kv_heads=cfg.n_kv_heads, hd=cfg.hd,
                              n_pages=ecfg.n_pages, n_devices=self.tp)
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
        # every linear's plan at the decode step's rows (the split-K
        # route's knobs do not depend on M)
        from repro_torch.runtime.tuner import linear_shapes
        self.linear_plans = {
            f"{k}x{n}": exec_plan.describe(
                "matmul", pol, w_dtype="float32", m=ecfg.max_batch, k=k,
                n=n) for k, n in linear_shapes(cfg)["dense"]}
        if ecfg.s_max % ecfg.prefill_chunk:
            raise ValueError(f"S_max ({ecfg.s_max}) must be a multiple of "
                             f"prefill_chunk ({ecfg.prefill_chunk})")
        self.model, self.params, self.ecfg = model, params, ecfg
        self.cfg, self.pol, self.device = cfg, pol, model.device
        if self.device.type == "cuda":
            # the kernel launches or raises: name what it refuses now
            kernel_formats(pol.fmt_attn, pol.fmt_kv, pol.kv_packed)
        self.spec, self.adaptive = spec, adaptive
        if self._spec_k and self.device.type == "cuda":
            check_verify_rows(pol, ecfg.max_batch * (self._spec_k + 1))
        # one draft view per rung (a static spec draft is a one-rung list
        # walked by no controller), all sharing params and page pool
        self.rungs: List[_Rung] = []
        if spec is not None:
            self.rungs.append(self._rung(spec.draft_policy, spec.k))
        if adaptive is not None:
            self.rungs += [self._rung(name, k) for name, k in
                           zip(adaptive.ladder, adaptive.rung_ks)]
            # overridable seam: tests install adversarial controllers
            # (e.g. switch-every-round) through this attribute
            self._ctrl_step = CTRL.step
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
            dict(self._shard_pool(KV.init_paged_kv_cache(
                ecfg.n_pages, ecfg.page_size, cfg.n_kv_heads, cfg.hd,
                fmt=pol.fmt_kv, packed=pol.kv_packed, device=self.device)),
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
        self.spec_rounds = 0
        self.spec_request_rounds = 0
        self.drafted = 0
        self.drafts_accepted = 0
        self.spec_emitted = 0
        n = len(self.rungs)
        self.rung_rounds, self.rung_drafted = [0] * n, [0] * n
        self.rung_accepted, self.rung_emitted = [0] * n, [0] * n
        self.rung_wall = [0.0] * n
        self.ctrl_switches = self.ctrl_demotes = self.ctrl_promotes = 0
        self.graphed = graphs and self.device.type == "cuda"
        pin = self.device.type == "cuda"
        self._tok_host = torch.empty((ecfg.max_batch,), dtype=torch.int32,
                                     pin_memory=pin)
        self._round_host = {
            k: torch.empty((ecfg.max_batch, k + 2), dtype=torch.int32,
                           pin_memory=pin)
            for k in sorted({r.k for r in self.rungs})}
        self._make_steps()

    def _init_tp(self, ecfg: EngineConfig, dev, graphs: bool):
        """The TP width this engine serves at and its group: ecfg.tp over
        the group active at construction, or 1 (replicated) with the
        reason in `tp_fallback`."""
        self.tp, self.tp_fallback, self._group = 1, "", None
        self._shard = (0, 1)
        if ecfg.tp <= 1:
            return
        group, world = TP.active_group(), TP.axis_size()
        if ecfg.tp > world:
            self.tp_fallback = (f"tp={ecfg.tp} exceeds the active group's "
                                f"{world} rank(s); serving replicated")
        elif ecfg.page_size % ecfg.tp:
            self.tp_fallback = (f"page_size={ecfg.page_size} not divisible "
                                f"by tp={ecfg.tp}; serving replicated")
        elif ecfg.tp < world:
            raise ValueError(f"tp={ecfg.tp} is less than the active group's "
                             f"{world} ranks: make a group of tp ranks "
                             "(launch.mesh)")
        else:
            if graphs and dev.type == "cuda":
                raise NotImplementedError(
                    f"tp={ecfg.tp} with graphs=True: the sharded steps' "
                    "collectives are not captured into CUDA graphs (gloo's "
                    "cannot be; NCCL capture needs >= 2 cards to test); "
                    f"pass graphs=False (--eager). Open in "
                    f"{GRAPHED_TP_ITEM}")
            self.tp, self._group = ecfg.tp, group
            self._shard = TP.shard()

    def _shard_pool(self, pool: dict) -> dict:
        """One layer's pool laid out on the TP group: this rank's slice of
        every page's rows (`cache_placement`'s KV rule)."""
        if self.tp == 1:
            return pool
        sizes = {SH.MODEL_AXIS: self.tp}
        coords = {SH.MODEL_AXIS: self._shard[0]}
        place = SH.cache_placement(pool, sizes)
        return {k: SH.take_shard(v, place[k], coords, sizes)
                for k, v in pool.items()}

    def _rung(self, name: str, k: int) -> _Rung:
        """Validate one draft policy against the serving one and build its
        view: the shared-cache precondition, its decode and verify plans,
        on the card the kernel's formats, and its load-time weights."""
        from repro_torch.models import build_model
        rpol = SPD.validate_policy_pair(name, self.pol)
        if self.device.type == "cuda":
            kernel_formats(rpol.fmt_attn, rpol.fmt_kv, rpol.kv_packed)
        rmodel = build_model(self.cfg.replace(policy=name),
                             device=self.device)
        if needs_prep(rpol) and not needs_prep(self.pol):
            rmodel.prepare_params(self.params)
        return _Rung(
            name=name, k=k, pol=rpol, model=rmodel,
            plan=exec_plan.describe("paged_decode", rpol, **self._plan_ctx),
            verify_plan=exec_plan.describe("verify_attn", self.pol,
                                           sq=k + 1, **self._plan_ctx))

    @property
    def _spec_k(self) -> int:
        """Draft-window rows priced into reservations and the submit
        guard: the ladder-wide max k in adaptive mode, so a rung switch
        mid-request never grows a request past what admission reserved."""
        if self.adaptive is not None:
            return self.adaptive.max_k
        return self.spec.k if self.spec is not None else 0

    def _make_steps(self):
        """The steps over static device buffers: the decode step (plain
        mode) or each rung's draft step and a verify step per distinct k
        (spec mode), and the prefill chunk.

        On the card with graphs all are captured here, into one memory
        pool, while every slot is idle and every block-table row is
        scratch: their warm-up calls write only the scratch page (the
        decode, draft and verify steps, positions 0) and staging rows [0,
        prefill_chunk) (the prefill chunk, index 0), which the first real
        chunk overwrites.  The steps replay one at a time, and what one
        hands the next (the drafts, their probabilities) lives in static
        buffers outside the pool; a graph's outputs hold until the next
        replay of any graph, so each step reads its own at once.

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

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        B = e.max_batch
        common = dict(positions=zeros(B), block_table=self._block_table,
                      rids=zeros(B))
        steps = []
        if not self.rungs:
            steps.append(("decode step", decode,
                          dict(common, tokens=zeros(B, 1,
                                                    dtype=torch.int64))))
        else:
            # what the draft steps hand the verify step: the drafts and,
            # sampled, their probabilities (B, max k, V)
            common["drafts"] = zeros(B, self._spec_k, dtype=torch.int64)
            if not scfg.greedy:
                common["draft_probs"] = zeros(
                    B, self._spec_k, self.cfg.vocab_size,
                    dtype=torch.float32)
            draft_bufs = dict(common, cur=zeros(B, 1, dtype=torch.int64),
                              i=zeros())
            for r in self.rungs:
                steps.append((f"draft step ({r.name})",
                              self._draft_fn(r.model), draft_bufs))
            verify_bufs = dict(common, tok0=zeros(B, 1, dtype=torch.int64))
            for k in self._round_host:
                steps.append((f"verify step (k={k})", self._verify_fn(k),
                              verify_bufs))
        steps.append(("prefill chunk", prefill, dict(
            tokens=zeros(1, e.prefill_chunk, dtype=torch.int64),
            index=zeros())))
        if self.graphed:
            pool = torch.cuda.graph_pool_handle()
            built = [StepGraph(fn, bufs, name=name, pool=pool)
                     for name, fn, bufs in steps]
        else:
            built = [Step(fn, bufs, name=name) for name, fn, bufs in steps]
        self._steps = built
        self._prefill = built[-1]
        self._decode = None if self.rungs else built[0]
        for r, step in zip(self.rungs, built):
            r.draft = step
        self._verify = dict(zip(self._round_host,
                                built[len(self.rungs):-1]))

    def _draft_fn(self, dmodel):
        """A rung's draft step over the shared buffers: one decode step of
        `dmodel` at positions + i on the tokens `cur`, whose token (drawn
        on `ROLE_DRAFT`) lands in drafts[:, i] (its probabilities in
        draft_probs[:, i]) and becomes the next `cur`, and i advances: k
        replays draft k tokens with nothing loaded between them."""
        dstep = SPD.make_draft_step(dmodel, self.sampler)
        params, caches = self.params, self.caches

        def draft(cur, positions, i, block_table, rids, drafts,
                  draft_probs=None):
            tok, probs, _ = dstep(params, {"tokens": cur,
                                           "index": positions + i},
                                  caches, rids)
            col = i.to(torch.int64).view(1)
            tok = tok.to(torch.int64)[:, None]
            drafts.index_copy_(1, col, tok)
            if draft_probs is not None:
                draft_probs.index_copy_(1, col, probs[:, None])
            cur.copy_(tok)
            i.add_(1)
            return tok

        return draft

    def _verify_fn(self, k: int):
        """The verify step at draft length k: one k+1-token pass of the
        serving model at positions over [tok0, drafts[:, :k]] and the
        accept rule -> (B, k+2) int32: the emitted tokens, then
        n_accepted."""
        accept = SPD.make_accept_fn(self.sampler, k)
        model, params, caches = self.model, self.params, self.caches

        def verify(tok0, positions, block_table, rids, drafts,
                   draft_probs=None):
            d = drafts[:, :k]
            logits, _ = model.decode_step(
                params, {"tokens": torch.cat([tok0, d], dim=1),
                         "index": positions}, caches)
            emitted, acc = accept(
                d, None if draft_probs is None else draft_probs[:, :k],
                logits, rids, positions)
            return torch.cat([emitted, acc[:, None]], dim=1)

        return verify

    # -- cache plumbing ----------------------------------------------------

    def _sync_tables(self):
        """Push the host block table into the shared device table."""
        self._steps[0].load(block_table=self._table)

    def _scatter_staging_to_pages(self, req: Request):
        """Copy the staged prompt rows into the request's pages, every
        layer (pure relayout).  A prefix hit scatters from its divergence
        point on: rows before `prefill_skip` live in shared (or
        copied-on-write) pages that must not be written."""
        for pool, staged in zip(self.caches, self._staging):
            rows = {k: staged[k][0] for k in KV.QUANT_KEYS}
            KV.write_prefill_rows(pool, rows, req.pages, req.n_prompt,
                                  start=req.prefill_skip, shard=self._shard)

    def _cow_copy(self, src: int, dst: int, n_rows: int):
        """Copy the first `n_rows` rows of pool page `src` into the private
        page `dst`, every layer, in place (pure relayout: the graphs read
        the pools at fixed addresses).  The shared source is only read.
        Sharded, each rank copies the rows of [0, n_rows) it holds."""
        ps_local = self.caches[0]["k_codes"].shape[1]
        n = min(max(n_rows - self._shard[0] * ps_local, 0), ps_local)
        for pool in self.caches:
            for k in KV.QUANT_KEYS:
                pool[k][dst, :n].copy_(pool[k][src, :n])
        self.cow_copies += 1

    def _load_prefix_to_staging(self, req: Request):
        """Copy the matched rows [0, prefill_skip) from the request's pages
        into the staging cache, in place (the inverse relayout of the
        scatter), so the warm prefill's chunks attend over exactly the
        codes and scales a cold prefill of the same prompt would have
        staged.  Sharded, the matched pages are all-gathered first (the
        staging cache holds whole rows on every rank)."""
        m = req.prefill_skip
        for pool, staged in zip(self.caches, self._staging):
            rows = self._prefix_rows(pool, req.pages, m)
            for k in KV.QUANT_KEYS:
                staged[k][0, :m].copy_(rows[k])

    def _prefix_rows(self, pool, pages, m: int) -> dict:
        """The first m timeline rows held in `pages`, as whole rows."""
        if self.tp == 1:
            return KV.gather_page_rows(pool, pages, m)
        n_pg = -(-m // self.ecfg.page_size)
        full = TP._gather_pool(KV.select_pages(pool, pages[:n_pg]),
                               self._group)
        return {k: v.reshape((-1,) + v.shape[2:])[:m]
                for k, v in full.items()}

    # -- lifecycle ---------------------------------------------------------

    def _pages_needed(self, req: Request) -> int:
        """Pages a request may touch over its lifetime; spec mode adds the
        draft window (a round writes rows up to pos + k)."""
        rows = req.n_prompt + req.max_new + self._spec_k
        return -(-rows // self.ecfg.page_size)

    def submit(self, req: Request):
        e = self.ecfg
        total = req.n_prompt + req.max_new + self._spec_k
        if total > e.s_max:
            raise ValueError(f"request {req.rid}: {total} tokens "
                             f"(incl. the {self._spec_k}-token draft "
                             f"window) exceed S_max = {e.s_max} "
                             "(raise max_pages_per_req or page_size)")
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
            if self.spec is not None:
                # lazy commit: reserve the lifetime worst case, take only
                # the prompt's pages now; rounds commit and roll back the
                # rest
                n0 = -(-req.n_prompt // self.ecfg.page_size)
                self.alloc.reserve(fresh)
                req.pages = shared + self.alloc.alloc(n0 - len(shared),
                                                      reserved=True)
                req.reserved_left = fresh - (n0 - len(shared))
            else:
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
            if self.adaptive is not None:
                req.rung = self.adaptive.start_rung
                req.ctrl = CTRL.init_state(self.adaptive)
            req.slot, req.state, req.t_admit = slot, PREFILL, now
            self.slots[slot] = req
            # the table row stays scratch until prefill lands: a PREFILL
            # slot rides decode steps as idle and must not touch its pages

    def _finish(self, req: Request, now: float):
        self.alloc.free(req.pages)
        req.pages = []
        if req.reserved_left:
            self.alloc.unreserve(req.reserved_left)
            req.reserved_left = 0
        self._table[req.slot] = KV.SCRATCH_PAGE
        self.slots[req.slot] = None
        req.slot = -1
        req.state, req.t_finish = FINISHED, now
        self.finished.append(req)
        self._tables_dirty = True

    def _maybe_finish(self, req: Request, tok: int, now: float):
        if req.n_generated >= req.max_new or tok == self.ecfg.eos_id:
            self._finish(req, now)

    def _commit_pages(self, req: Request, n_rows: int) -> bool:
        """Commit pages out of the request's reservation until its block
        table covers `n_rows` timeline rows; True when the host table
        changed."""
        need = -(-n_rows // self.ecfg.page_size) - len(req.pages)
        if need <= 0:
            return False
        if need > req.reserved_left:
            raise RuntimeError(
                f"request {req.rid}: {n_rows} rows need {need} more pages "
                f"but only {req.reserved_left} are reserved (reservation "
                "accounting bug)")
        for pid in self.alloc.alloc(need, reserved=True):
            self._table[req.slot, len(req.pages)] = pid
            req.pages.append(pid)
        req.reserved_left -= need
        return True

    def _rollback(self, req: Request, n_rows: int):
        """Return committed pages past the accepted timeline (`n_rows`
        valid rows) to the request's reservation and point the table's
        tail at scratch.  Pages the accepted timeline still touches stay
        (their stale rows are masked by position and rewritten by the
        next round)."""
        keep = -(-n_rows // self.ecfg.page_size)
        drop = req.pages[keep:]
        if not drop:
            return
        self.alloc.free(drop, to_reserved=True)
        req.reserved_left += len(drop)
        req.pages = req.pages[:keep]
        self._table[req.slot, keep:] = KV.SCRATCH_PAGE
        self._tables_dirty = True

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

    def _live_batch(self):
        """(live requests, tokens (B, 1), positions (B,), rids (B,)) for
        one fixed-shape step; idle slots ride along at scratch."""
        e = self.ecfg
        live = [r for r in self.slots if r is not None and r.state == DECODE]
        tokens = np.zeros((e.max_batch, 1), np.int64)
        positions = np.zeros((e.max_batch,), np.int32)
        rids = np.zeros((e.max_batch,), np.int32)
        for r in live:
            tokens[r.slot, 0] = r.out_tokens[-1]
            positions[r.slot] = r.pos
            rids[r.slot] = r.rid
        return live, tokens, positions, rids

    def _read_back(self, host, out):
        """A step's output through a pinned buffer: the one host sync."""
        host.copy_(out, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return host.numpy()

    def _decode_batch(self, now: float) -> int:
        """One batched decode step over every DECODE-state slot."""
        live, tokens, positions, rids = self._live_batch()
        if not live:
            return 0
        inputs = dict(tokens=tokens, positions=positions)
        if not self.sampler.greedy:
            inputs["rids"] = rids
        nxt = self._decode(**inputs)
        self.n_decode_steps += 1
        nxt = self._read_back(self._tok_host, nxt)
        for r in live:
            tok = int(nxt[r.slot])
            r.pos += 1
            r.out_tokens.append(tok)
            self._maybe_finish(r, tok, now)
        return len(live)

    def _spec_round(self, now: float, live: List[Request], rung_i: int) -> int:
        """One speculative round over the `live` participants with rung
        `rung_i`'s draft step: k draft steps, one k+1-token verify pass
        with the accept rule, then the rollback of pages holding only
        rejected rows (and, adaptive, the controller's update).  Returns
        the token-budget cost, 2k+1 model tokens a participant.

        `live` may be a subset of the DECODE slots (adaptive mode batches
        by rung); the fixed-shape batch carries every DECODE slot at its
        real (last token, position), and only participants' outputs are
        read (the module doc's ghosts)."""
        e, rung = self.ecfg, self.rungs[rung_i]
        k, draft, verify = rung.k, rung.draft, self._verify[rung.k]
        _, tokens, positions, rids = self._live_batch()
        # commit the participants' draft window (rows pos .. pos + k) and
        # push the grown tables before anything reads them
        dirty = [self._commit_pages(r, r.pos + k + 1) for r in live]
        if any(dirty) or self._tables_dirty:
            self._sync_tables()
            self._tables_dirty = False
        inputs = dict(cur=tokens, positions=positions, i=0)
        if not self.sampler.greedy:
            inputs["rids"] = rids
        draft.load(**inputs)
        verify.load(tok0=tokens)
        for _ in range(k):
            draft.run()
        out = self._read_back(self._round_host[k], verify.run())
        self.spec_rounds += 1
        self.spec_request_rounds += len(live)
        self.rung_rounds[rung_i] += 1
        for r in live:
            a = int(out[r.slot, k + 1])
            self.drafted += k
            self.drafts_accepted += a
            emit = [int(t) for t in
                    out[r.slot, :min(a + 1, r.max_new - r.n_generated)]]
            for j, tok in enumerate(emit):
                if tok == e.eos_id:
                    emit = emit[:j + 1]
                    break
            r.out_tokens.extend(emit)
            r.pos += len(emit)
            self.spec_emitted += len(emit)
            self.rung_drafted[rung_i] += k
            self.rung_accepted[rung_i] += a
            self.rung_emitted[rung_i] += len(emit)
            if r.n_generated >= r.max_new or emit[-1] == e.eos_id:
                self._finish(r, now)
                continue
            self._rollback(r, r.pos)
            if self.adaptive is not None:
                # pure feedback update, no wall clock, no RNG; the seam
                # is overridable, so tests can drive adversarial
                # trajectories
                r.ctrl, nxt = self._ctrl_step(self.adaptive, r.ctrl, a, k)
                if nxt != r.rung:
                    self.ctrl_switches += 1
                    if nxt < r.rung:
                        self.ctrl_demotes += 1
                    else:
                        self.ctrl_promotes += 1
                    r.rung = nxt
        return len(live) * (2 * k + 1)

    def _spec_decode_all(self, now: float) -> int:
        """A speculative tick: one round over every DECODE slot (static
        draft), or, adaptive, one round per non-empty rung group, the
        groups taken up front (a request that switches rungs during its
        own round is not served twice in one tick)."""
        live = [r for r in self.slots if r is not None and r.state == DECODE]
        if not live:
            return 0
        if self.adaptive is None:
            return self._spec_round(now, live, 0)
        groups = [[r for r in live if r.rung == i]
                  for i in range(len(self.rungs))]
        cost = 0
        for i, group in enumerate(groups):
            if group:
                t0 = time.monotonic()
                cost += self._spec_round(now, group, i)
                self.rung_wall[i] += time.monotonic() - t0
        return cost

    def step(self, now: float = 0.0):
        """One scheduler tick: admit, decode the running batch (one
        speculative round in spec mode), spend the leftover token budget
        on prefill chunks; under the DB active at construction."""
        before = exec_plan.use_tuned_db(self.tuned_db)
        try:
            # the engine's own group (None when replicated), whatever the
            # caller has active
            with TP.activate(self._group):
                self._tick(now)
        finally:
            exec_plan.use_tuned_db(before)

    def _tick(self, now: float):
        self._admit(now)
        budget = self.ecfg.token_budget - (
            self._spec_decode_all(now) if self.rungs
            else self._decode_batch(now))
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
            if self.tp > 1:
                # ranks step in lockstep: one clock for admissions
                now = TP.agree(now, self._group)
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
            "decode_selection": self.plan["selection"],
            "linear_plans": {
                shape: {"route": d["route"], "selection": d["selection"],
                        "knobs": d.get("tuned_knobs", {})}
                for shape, d in self.linear_plans.items()},
            "tuned_db": self.tuned_db,
            "decode_bytes_per_step_layer": self.plan["bytes_moved"],
            "temperature": self.sampler.temperature,
            "device": str(self.device),
            "graphs": self.graphed,
            **self.kv_bytes_report(),
        }
        if self.graphed:
            rep["capture"] = {step.name: step.stats for step in self._steps}
        if self.rungs:
            rep.update(self.spec_report())
        if self.prefix is not None:
            rep.update(self.prefix_report())
        if self.cfg.is_moe:
            rep.update(self.moe_report())
        rep.update(self.tp_report(rep["paged_bytes"]))
        return rep

    def tp_report(self, paged_bytes: int) -> dict:
        """The TP width served and requested, a fallback's reason, and,
        sharded, the wire and the pool's residency from the rank's own
        pool tensors: one decode step all-gathers every layer's pool, so
        each rank receives (tp - 1) / tp of the codes + scales of every
        layer; and whether the wire stages CUDA tensors through host
        memory (fixed by the backend, `distributed.tp`)."""
        rep = {"tp": self.tp}
        if self.ecfg.tp > 1:
            rep["tp_requested"] = self.ecfg.tp
            if self.tp_fallback:
                rep["tp_fallback_reason"] = self.tp_fallback
        if self.tp == 1:
            return rep
        e, cfg = self.ecfg, self.cfg
        local_layer = sum(int(self.caches[0][k].nbytes)
                          for k in KV.QUANT_KEYS)
        pool_layer = local_layer * self.tp
        f32_layer = 2 * 4 * (e.n_pages * e.page_size * cfg.n_kv_heads
                             * cfg.hd)
        wire_layer = (self.tp - 1) * pool_layer // self.tp
        rep.update({
            "tp_rank": self._shard[0],
            "tp_backend": str(dist.get_backend(self._group)),
            "tp_wire_staged_through_host": (
                self.device.type == "cuda"
                and TP.stages_through_host(self._group)),
            "tp_wire_bytes_per_step_layer": wire_layer,
            "tp_wire_bytes_per_step": wire_layer * cfg.n_layers,
            "tp_wire_reduction_vs_f32": f32_layer / pool_layer,
            "pool_bytes_per_device": paged_bytes // self.tp,
            "pool_bytes_allocated_per_device": local_layer * cfg.n_layers,
        })
        return rep

    def spec_report(self) -> dict:
        """Who drafted and who verified, acceptance, tokens a round, the
        draft and verify steps run; adaptive, per rung and the
        controller's switches.  `acceptance_rate` is the drafted-token-
        weighted aggregate over rungs."""
        rep = {
            "spec_rounds": self.spec_rounds,
            "acceptance_rate": (self.drafts_accepted / self.drafted
                                if self.drafted else 0.0),
            # tokens one request advances a round it takes part in, in
            # [1, k+1]
            "eff_tokens_per_round": (self.spec_emitted
                                     / self.spec_request_rounds
                                     if self.spec_request_rounds else 0.0),
            "draft_steps": sum(n * r.k for n, r in
                               zip(self.rung_rounds, self.rungs)),
            "verify_steps": self.spec_rounds,
            "verify_route": self.rungs[0].verify_plan["route"],
            "verify_backend": self.rungs[0].verify_plan["backend"],
        }
        if self.spec is not None:
            r = self.rungs[0]
            rep.update({"spec_draft_policy": self.spec.draft_policy,
                        "spec_k": self.spec.k,
                        "draft_route": r.plan["route"],
                        "draft_backend": r.plan["backend"]})
            return rep
        tw = sum(self.rung_wall)
        rep.update({
            "adaptive_ladder": [r.name for r in self.rungs],
            "adaptive_switches": self.ctrl_switches,
            "adaptive_demotes": self.ctrl_demotes,
            "adaptive_promotes": self.ctrl_promotes,
            "adaptive_rungs": [{
                "policy": r.name,
                "k": r.k,
                "rounds": self.rung_rounds[i],
                "drafted": self.rung_drafted[i],
                "accepted": self.rung_accepted[i],
                "acceptance_rate": (self.rung_accepted[i]
                                    / self.rung_drafted[i]
                                    if self.rung_drafted[i] else 0.0),
                "emitted": self.rung_emitted[i],
                "wall_share": self.rung_wall[i] / tw if tw > 0 else 0.0,
                "draft_route": r.plan["route"],
                "draft_backend": r.plan["backend"],
            } for i, r in enumerate(self.rungs)]})
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
            "moe_grouped_selection": plan["selection"],
            "moe_grouped_bytes_per_step_layer": plan["bytes_moved"],
            "expert_w_bytes": w_bytes,
            "expert_w_bytes_f32": 4 * n_w,
            "expert_w_reduction_vs_f32": 4 * n_w / w_bytes,
        }


def format_report(rep: dict, policy: str) -> str:
    """The front end's report lines (the reference's `format_report` for
    the keys the port reports): throughput and latency, cache bytes from
    actual per-request lengths and page use, the decode plan, and the
    spec, adaptive, prefix-cache and MoE lines where the report has
    them."""
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
        + (f"\nspec: draft k={rep['spec_k']} under "
           f"{rep['spec_draft_policy']} via {rep['draft_route']} "
           f"[{rep['draft_backend']}], verify via {rep['verify_route']} "
           f"[{rep['verify_backend']}]; acceptance "
           f"{rep['acceptance_rate']:.0%}, "
           f"{rep['eff_tokens_per_round']:.2f} tokens/round over "
           f"{rep['spec_rounds']} rounds"
           if "spec_k" in rep else "")
        + ((f"\nadaptive: {len(rep['adaptive_rungs'])}-rung ladder, "
            f"{rep['adaptive_switches']} switches "
            f"({rep['adaptive_demotes']} demote, "
            f"{rep['adaptive_promotes']} promote); acceptance "
            f"{rep['acceptance_rate']:.0%}, "
            f"{rep['eff_tokens_per_round']:.2f} tokens/round over "
            f"{rep['spec_rounds']} rounds\n"
            + "\n".join(
                f"  rung {i}: {r['policy']} (k={r['k']}) acceptance "
                f"{r['acceptance_rate']:.0%}, {r['rounds']} rounds, "
                f"{r['drafted']} drafted, {r['emitted']} emitted, "
                f"{r['wall_share']:.0%} of spec wall via "
                f"{r['draft_route']} [{r['draft_backend']}]"
                for i, r in enumerate(rep["adaptive_rungs"])))
           if "adaptive_rungs" in rep else "")
        + (f"\nprefix: {rep['prefix_hits']}/{rep['prefix_queries']} hits "
           f"({rep['prefix_hit_rate']:.0%}), "
           f"{rep['prefill_tokens_saved']} prefill tokens saved, "
           f"{rep['prefix_cow_copies']} CoW copies; "
           f"{rep['resident_prefix_pages']} resident pages "
           f"({rep['resident_prefix_bytes'] / mb:.2f} MB at format width)"
           if "prefix_hit_rate" in rep else "")
        + (f"\ntp: {rep['tp']} ranks, pool "
           f"{rep['pool_bytes_per_device'] / mb:.2f} MB/rank in use "
           f"({rep['pool_bytes_allocated_per_device'] / mb:.2f} MB "
           f"allocated); wire {rep['tp_wire_bytes_per_step_layer'] / 1e3:.1f}"
           f" KB codes+scales per step/layer "
           f"({rep['tp_wire_reduction_vs_f32']:.1f}x under an f32 wire), "
           f"{rep['tp_backend']}"
           + (" staged through host memory"
              if rep["tp_wire_staged_through_host"] else "")
           if rep.get("tp", 1) > 1 else "")
        + (f"\ntp: requested {rep['tp_requested']}, serving replicated — "
           f"{rep['tp_fallback_reason']}"
           if "tp_fallback_reason" in rep else "")
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
