"""Serving entry point (port of `repro.launch.serve`): static greedy serving
(`generate`) and the continuous-batching engine's front end.

  python -m repro_torch.launch.serve --arch qwen3-4b --engine \
      --policy w4a8_kv4_attn8 --requests 8 --prompt-len 192 --gen 32 \
      --temperature 0.8 --top-k 50 --top-p 0.95

Two modes, as the reference's:

  static (default) : one rigid (B, s_ctx) batch stepped in lockstep: the
      prompt is fed through the decode path token by token (exercising
      the exact serving cache path), then generation continues greedily.
      Each step is `distributed.step.make_serve_step`, which the
      reference jits; on the card it is captured once per call as a CUDA
      graph (`launch.graphs`).
  --engine : the continuous-batching engine (`launch.engine`) over the
      paged quantized KV cache, serving an open-loop synthetic workload
      (`synthetic_workload`), greedy or sampled, with the prefix cache on
      request, speculative with `--spec-draft` (draft under that policy,
      verify under --policy, `--spec-k` tokens a round) or adaptive with
      `--adaptive-draft` (the default precision ladder of --policy); it
      prints the reference's report lines (tokens/s, latency p50/p99,
      TTFT p50, KV bytes, plan, spec, adaptive, prefix, moe).  Speculation
      serves wherever the reference's does, on the card too: every paged
      --policy (f32, fake-quant or kernel linears, at any --max-batch) and
      MoE configs (whose verify pass sizes expert capacity for its k+1
      tokens, as the reference's does).

Weights are `model.init(torch.Generator(device).manual_seed(0))` (the
reference's `PRNGKey(0)`; `--seed` seeds the workload and the sampler).
Everything runs on `--device` (default "cuda"); `--eager` runs the steps
without CUDA graphs.  The port's default block table holds 16 pages (the
reference's 8), so that a 192-token prompt and 32 new tokens fit.

`--tuned-db PATH` serves with a measurement DB (`python -m
repro_torch.launch.tune`): it is made active (`exec_plan.use_tuned_db`)
before the model is built, so every plan the steps resolve and capture
consults it, and the engine takes its fastest engine knobs (page size,
rescaling `--max-pages-per-req` so S_max is kept, and speculative k), as
the reference's front end does.

`--tp N` with `--engine` serves tensor-parallel: `launch.mesh.run_ranks`
spawns N ranks over `--dist-backend` (nccl: one card a rank; gloo: the
CPU, or ranks that share a card), each running the engine on the same
requests with 1/N of the page pool; rank 0 prints the report, and every
rank's tokens must equal rank 0's.  The TP steps run eagerly: on the card
`--tp` needs `--eager` (`engine.GRAPHED_TP_ITEM`).

`--n-model` above 1 exits naming its ROADMAP item (Queue 1,
"Model-parallel serving and training (`--n-model`)").
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import time
from typing import Optional

import torch

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import exec_plan
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import get_policy
from repro_torch.distributed.step import MODEL_PARALLEL_ITEM, make_serve_step
from repro_torch.launch.graphs import Step, StepGraph
from repro_torch.models import build_model
from repro_torch.models.transformer import layer_kinds

# the reference's `hlo_analysis.plan_routes` shapes: each op's ctx
PLAN_ROUTES = {
    "matmul": {"w_dtype": "float32"},
    "flash_attn": {"sq": 128, "skv": 128, "use_flash": True},
    "decode_attn": {"s_ctx": 128},
    "paged_decode": {"page_size": 16, "max_pages": 8},
    "verify_attn": {"page_size": 16, "max_pages": 8, "sq": 4},
}


def plan_routes(policy, shapes=None) -> dict:
    """-> {op: exec_plan.describe(...) or None} for the ops a serving step
    exercises under `policy` (None: no route serves it, or the port does
    not have the op yet)."""
    pol = get_policy(policy)
    ctx = {op: dict(c) for op, c in PLAN_ROUTES.items()}
    for op, over in (shapes or {}).items():
        ctx.setdefault(op, {}).update(over)
    out = {}
    for op, c in ctx.items():
        try:
            out[op] = exec_plan.describe(op, pol, **c)
        except exec_plan.PlanError:
            out[op] = None
    return out


def report_plan(cfg, s_ctx: int) -> str:
    """One line naming the routes this policy's static serving step
    resolves to (paged_decode is the engine's, left out here)."""
    routes = plan_routes(cfg.policy, shapes={
        "flash_attn": {"sq": s_ctx, "skv": s_ctx,
                       "use_flash": cfg.use_flash},
        "decode_attn": {"s_ctx": s_ctx, "kv_heads": cfg.n_kv_heads,
                        "hd": cfg.hd}})
    static_ops = ("matmul", "flash_attn", "decode_attn")
    parts = [f"{op}->{routes[op]['route']}" for op in sorted(static_ops)
             if routes.get(op) is not None]
    return "plan: " + " ".join(parts)


def report_kv_cache(cfg, batch: int, s_ctx: int) -> str:
    """One-line KV-cache footprint for the selected policy, over the full
    attention layers (a local layer's raw window cache and the recurrent
    states are not counted, as in the reference)."""
    pol = get_policy(cfg.policy)
    if not pol.kv_quantized:
        return "kv-cache: raw %s (policy %s)" % (cfg.dtype, cfg.policy)
    from repro_torch.core.kvcache import kv_cache_nbytes
    nb = kv_cache_nbytes(batch, s_ctx, cfg.n_kv_heads, cfg.hd,
                         fmt=pol.fmt_kv, packed=pol.kv_packed)
    n_attn = layer_kinds(cfg).count("attn")
    return (f"kv-cache: {pol.fmt_kv}{' packed' if pol.kv_packed else ''} "
            f"{nb['total'] * n_attn / 1e6:.2f} MB vs f32 "
            f"{nb['f32_total'] * n_attn / 1e6:.2f} MB "
            f"({nb['reduction_vs_f32']:.2f}x fewer bytes/decode-step, "
            f"{n_attn} attn layers)")


@torch.no_grad()
def generate(model, params, prompt, n_gen: int, s_ctx: int, device=None,
             graphs: bool = True):
    """prompt: (B, S0) int tokens -> (B, S0 + n_gen) int32, on `device`
    (default "cuda", which must be where the model lives).  Greedy.

    On the card with `graphs` the serve step is one CUDA graph over two
    buffers, the (B, 1) tokens and the 0-dim int32 index, filled device
    to device at each step (the next prompt column or the replayed next
    tokens; the indices are one device `arange`), so nothing waits for
    the host before the final concatenation.  Its capture's warm-up call
    is step 0 itself (the buffers start at step 0's inputs), so the
    call makes as many model steps as the eager one.  With
    `graphs=False`, and always on the CPU, the same step runs eagerly.
    `generate.capture_stats` holds the last call's capture statistics
    (`StepGraph.stats`; None when eager)."""
    dev = resolve_device(device)
    if dev.type != model.device.type:
        raise ValueError(f"model lives on {model.device}, not {dev}")
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(model.device)
    B, S0 = prompt.shape
    caches = model.init_caches(B, s_ctx)
    serve_step = make_serve_step(model)

    def step(tokens, index):
        nxt, _ = serve_step(params, {"tokens": tokens, "index": index},
                            caches)
        return nxt

    buffers = {"tokens": prompt[:, :1].clone(),
               "index": torch.zeros((), dtype=torch.int32,
                                    device=model.device)}
    run = (StepGraph(step, buffers, name="serve step")
           if graphs and model.device.type == "cuda"
           else Step(step, buffers, name="serve step"))
    generate.capture_stats = getattr(run, "stats", None)
    index = torch.arange(S0 + n_gen - 1, dtype=torch.int32,
                         device=model.device)
    toks = [prompt[:, :1]]
    for t in range(S0 + n_gen - 1):
        nxt = run(index=index[t]) if t else run.first()
        tok = (prompt[:, t + 1:t + 2] if t + 1 < S0
               else nxt[:, None].to(torch.int64))
        run.load(tokens=tok)
        toks.append(tok)
    return torch.cat(toks, dim=1).to(torch.int32)


generate.capture_stats = None


def _refuse_unported(args) -> None:
    """Exit on a flag whose module the port does not have yet, or a --tp
    run the flags do not describe whole."""
    if args.n_model > 1:
        raise SystemExit(f"--n-model {args.n_model}: model-parallel "
                         f"serving is not ported yet ({MODEL_PARALLEL_ITEM})")
    if args.tp > 1 and not args.engine:
        raise SystemExit(f"--tp {args.tp} serves through the engine: add "
                         "--engine")
    if args.tp > 1 and not args.dist_backend:
        raise SystemExit(f"--tp {args.tp}: name the collectives' backend "
                         "with --dist-backend nccl or gloo")
    if args.tp > 1 and resolve_device(args.device).type == "cuda" \
            and not args.eager:
        from repro_torch.launch.engine import GRAPHED_TP_ITEM
        raise SystemExit(f"--tp {args.tp} on the card runs its steps "
                         f"eagerly: add --eager ({GRAPHED_TP_ITEM})")


def apply_tuned_engine_knobs(args) -> Optional[dict]:
    """The DB's fastest engine knob point applied to the engine flags:
    the page size (with `--max-pages-per-req` rescaled so S_max, the
    tokens a request may hold, is kept) and, where no draft policy was
    named, speculative k under the tuner's draft policy.  -> the point
    (None: the DB has none for this environment)."""
    from repro_torch.runtime import tuner
    best = tuner.best_engine_knobs(args.tuned_db)
    if not best:
        return None
    ps = int(best.get("page_size", args.page_size))
    if ps != args.page_size:
        s_max = args.page_size * args.max_pages_per_req
        args.max_pages_per_req = max(1, s_max // ps)
        args.page_size = ps
    if not args.spec_draft and not args.adaptive_draft and \
            int(best.get("spec_k", 0)) > 0:
        args.spec_draft = tuner.ENGINE_DRAFT_POLICY
        args.spec_k = int(best["spec_k"])
    print(f"tuned engine knobs from {args.tuned_db}: {best}")
    return best


def run_engine(cfg, model, params, args):
    """--engine mode: continuous batching over the paged quantized cache,
    driven by an open-loop synthetic workload.  --spec-draft turns on
    self-speculative decoding (draft under the named low-precision
    policy, verify under --policy); --adaptive-draft replaces the static
    draft policy with the acceptance-feedback precision ladder; --mixed
    makes the traffic heterogeneous, --shared-prefix gives every prompt a
    common prefix, --prefix-cache shares it; --temperature / --top-k /
    --top-p select sampling (default greedy).  -> the engine's report."""
    from repro_torch.launch.engine import (Engine, EngineConfig,
                                           format_report,
                                           synthetic_workload)
    from repro_torch.runtime.controller import (ControllerConfig,
                                                default_ladder)
    from repro_torch.serving.sampler import SamplerConfig
    from repro_torch.serving.spec_decode import SpecConfig
    ecfg = EngineConfig(page_size=args.page_size, n_pages=args.pages,
                        max_batch=args.max_batch or args.batch,
                        max_pages_per_req=args.max_pages_per_req,
                        token_budget=args.token_budget,
                        prefill_chunk=args.prefill_chunk,
                        prefix_cache=args.prefix_cache, tp=args.tp)
    adaptive = None
    if args.adaptive_draft:
        if args.spec_draft:
            raise SystemExit("--adaptive-draft replaces --spec-draft "
                             "(the ladder covers the static draft "
                             "policy); pass one or the other")
        adaptive = ControllerConfig(default_ladder(cfg.policy),
                                    k=args.spec_k)
    spec = SpecConfig(args.spec_draft, args.spec_k) if args.spec_draft \
        else None
    spec_k = adaptive.max_k if adaptive else (args.spec_k if spec else 0)
    # mixed traffic stretches the longest request to 4x the --gen /
    # --prompt-len ceilings (see synthetic_workload); guard for that
    p_max = 4 * args.prompt_len if args.mixed > 0 else args.prompt_len
    g_max = 4 * args.gen if args.mixed > 0 else args.gen
    if args.shared_prefix + p_max + g_max + spec_k > ecfg.s_max:
        raise SystemExit(
            f"--shared-prefix {args.shared_prefix} + prompt {p_max} + "
            f"gen {g_max}{' (4x for --mixed)' if args.mixed > 0 else ''} "
            f"(+ the {spec_k}-token draft window) exceeds the engine's "
            f"S_max = {ecfg.s_max} tokens/request; raise "
            "--max-pages-per-req or --page-size")
    sampler = SamplerConfig(temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed)
    engine = Engine(model, params, ecfg, sampler=sampler, spec=spec,
                    adaptive=adaptive, device=args.device,
                    graphs=not args.eager)
    reqs = synthetic_workload(
        args.requests, vocab=cfg.vocab_size, seed=args.seed,
        rate=args.rate, prompt_range=(max(1, args.prompt_len // 2),
                                      args.prompt_len),
        gen_range=(max(1, args.gen // 2), args.gen),
        shared_prefix=args.shared_prefix, mixed=args.mixed)
    rep = engine.run(reqs)
    run_engine.last_tokens = {r.rid: list(r.out_tokens)
                              for r in engine.finished}
    print(format_report(rep, cfg.policy))
    if engine.finished:
        sample = engine.finished[0]
        print(f"sample (req {sample.rid}): {sample.tokens()[:24].tolist()}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2, allow_nan=False)
        print(f"report written to {args.json}")
    return rep


run_engine.last_tokens = None


# seconds a --tp run's ranks may take before they are stopped and the
# run fails (a hung collective must not hold the caller forever)
TP_TIMEOUT = 3600.0


def _serve_rank(rank, device, args):
    """One rank of a --tp run: the flags served on the rank's device, its
    printed lines kept -> (report, tokens by request, printed text)."""
    args = argparse.Namespace(**dict(vars(args), device=str(device)))
    if rank:
        args.json = ""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = _serve_flags(args)
    return rep, run_engine.last_tokens, out.getvalue()


def serve_tp(args) -> dict:
    """--tp N: N ranks (`launch.mesh.run_ranks`) serve the same requests;
    rank 0's lines are printed, and every rank's tokens must equal rank
    0's (the sharded routes are pure relayouts) -> rank 0's report."""
    from repro_torch.launch.mesh import run_ranks
    outs = run_ranks(_serve_rank, args.tp, backend=args.dist_backend,
                     device=args.device, timeout=TP_TIMEOUT,
                     init_method=args.dist_init or None, args=(args,))
    print(outs[0][2], end="")
    for rank, (_, tokens, _) in enumerate(outs):
        if tokens != outs[0][1]:
            raise SystemExit(f"rank {rank}'s tokens differ from rank 0's")
    print(f"tp: {args.tp} ranks over {args.dist_backend}, every rank's "
          "tokens equal rank 0's")
    run_engine.last_tokens = outs[0][1]
    return outs[0][0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--policy", default=None)
    ap.add_argument("--n-model", type=int, default=1,
                    help="model-parallel width (only 1 is served)")
    ap.add_argument("--device", default="cuda",
                    help="where the model and the steps run")
    ap.add_argument("--eager", action="store_true",
                    help="run the steps without CUDA graphs")
    eg = ap.add_argument_group("engine", "continuous-batching mode")
    eg.add_argument("--engine", action="store_true",
                    help="serve with the paged-cache engine")
    eg.add_argument("--page-size", type=int, default=16)
    eg.add_argument("--pages", type=int, default=128,
                    help="page-pool capacity (page 0 is scratch)")
    eg.add_argument("--max-batch", type=int, default=0,
                    help="decode slots (default: --batch)")
    eg.add_argument("--max-pages-per-req", type=int, default=16)
    eg.add_argument("--token-budget", type=int, default=32,
                    help="tokens per scheduler step")
    eg.add_argument("--prefill-chunk", type=int, default=16)
    eg.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width: ranks spawned, each "
                         "holding 1/tp of the page pool")
    eg.add_argument("--dist-backend", choices=("nccl", "gloo"), default="",
                    help="collectives' backend for --tp (no default: "
                         "nccl for one card a rank, gloo for the CPU or "
                         "ranks sharing a card)")
    eg.add_argument("--dist-init", default="",
                    help="--tp ranks' rendezvous (file:///path or "
                         "tcp://host:port; default: a file store in a "
                         "fresh temporary directory)")
    eg.add_argument("--requests", type=int, default=16)
    eg.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, req/s (0 = all at t=0)")
    eg.add_argument("--seed", type=int, default=0,
                    help="workload + sampler RNG seed")
    eg.add_argument("--prefix-cache", action="store_true",
                    help="share identical prompt prefixes across requests "
                         "(ref-counted pages + copy-on-write)")
    eg.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend this many shared system-prompt tokens "
                         "to every synthetic request")
    eg.add_argument("--mixed", type=float, default=0.0,
                    help="fraction of long-prompt/long-gen requests in "
                         "the synthetic workload (0 = homogeneous)")
    eg.add_argument("--json", default="",
                    help="also dump the engine report to this JSON file")
    eg.add_argument("--tuned-db", default="",
                    help="measurement DB (python -m repro_torch.launch."
                         "tune): measured launch plans for every route, "
                         "and the engine's page size and speculative k")
    sg = ap.add_argument_group("sampling + speculation", "engine mode")
    sg.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy argmax)")
    sg.add_argument("--top-k", type=int, default=0,
                    help="keep the k largest logits (0 = off)")
    sg.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass (1.0 = off)")
    sg.add_argument("--spec-draft", default="",
                    help="draft policy preset for self-speculative "
                         "decoding (e.g. w4a4_kv4_attn4; empty = off)")
    sg.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens per speculative round")
    sg.add_argument("--adaptive-draft", action="store_true",
                    help="adaptive trans-precision drafting: walk the "
                         "default draft-precision ladder for --policy "
                         "with the acceptance-feedback controller "
                         "(repro_torch.runtime.controller) instead of one "
                         "static --spec-draft policy")
    args = ap.parse_args(argv)
    _refuse_unported(args)
    if args.tp > 1:
        return serve_tp(args)
    return _serve_flags(args)


def _serve_flags(args):
    """Serve as the parsed flags say, with their measurement DB active."""
    if not args.tuned_db:
        return serve(args)
    before = exec_plan.use_tuned_db(args.tuned_db)
    try:
        if args.engine:
            apply_tuned_engine_knobs(args)
        return serve(args)
    finally:
        exec_plan.use_tuned_db(before)


def serve(args):
    """Build the model and serve as the parsed flags say."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduce_config(cfg)
    if args.engine and not args.policy:
        args.policy = "kv4_attn8_packed"    # engine needs a fmt_kv preset
    if args.policy:
        cfg = cfg.replace(policy=args.policy)
    if cfg.family in ("encdec", "vlm") or cfg.frontend == "stub":
        raise SystemExit("serve demo targets token-in/token-out archs")
    dev = resolve_device(args.device)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    if args.engine:
        return run_engine(cfg, model, params, args)
    print(report_kv_cache(cfg, args.batch, args.prompt_len + args.gen))
    print(report_plan(cfg, args.prompt_len + args.gen))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1))
    t0 = time.monotonic()
    out = generate(model, params, prompt, args.gen,
                   args.prompt_len + args.gen, device=dev,
                   graphs=not args.eager)
    out = out.cpu()
    wall = time.monotonic() - t0
    steps = args.prompt_len + args.gen - 1
    print(f"generated {tuple(out.shape)} in {wall:.2f}s "
          f"({steps * args.batch / wall:.1f} tok/s, policy={cfg.policy})")
    print("sample:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()
