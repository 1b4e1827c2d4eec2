"""Rank bodies of the port's tensor-parallel tests (`tests/test_torch_tp.py`,
`tests/test_torch_collectives.py`): module-level functions that
`repro_torch.launch.mesh.run_ranks` spawns, each inside a gloo group of
CPU ranks.  No JAX here, so a rank starts with torch and repro_torch
alone; the tests hold what the ranks return against the JAX reference.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_config
from repro_torch.core import kvcache as KV
from repro_torch.distributed import tp as TP

# the reduced qwen3-4b engine at the reference tests' geometry
# (tests/test_tp_engine.py)
POLICIES = ("attn_fp16_dpa", "kv8_attn_f32", "kv4_attn8_packed")
PREFIX_POLICY = "kv4_attn8_packed"
SPEC_DRAFT = "w4a4_kv4_attn4"
GEOM = dict(page_size=8, n_pages=32, max_batch=4, max_pages_per_req=4,
            token_budget=16, prefill_chunk=8)
PREFIX_GEOM = dict(GEOM, n_pages=48, prefix_cache=True)
SPEC_GEOM = dict(GEOM, n_pages=48, token_budget=32)
# page 5 does not divide by 2 ranks (S_max 30 = 6 chunks of 5)
INDIVISIBLE_GEOM = dict(GEOM, page_size=5, max_pages_per_req=6,
                        prefill_chunk=5)


def workload(mod, kind, vocab):
    """The requests of each run, from `mod.synthetic_workload` (the
    port's and the reference's draw the same numpy stream)."""
    if kind == "plain":
        return mod.synthetic_workload(4, vocab=vocab, seed=0,
                                      prompt_range=(6, 18), gen_range=(4, 8))
    if kind == "prefix":
        return mod.synthetic_workload(5, vocab=vocab, seed=0,
                                      prompt_range=(4, 10), gen_range=(4, 6),
                                      shared_prefix=12)
    return mod.synthetic_workload(4, vocab=vocab, seed=2,
                                  prompt_range=(6, 14), gen_range=(4, 8))


def tokens_of(engine) -> dict:
    return {int(r.rid): [int(t) for t in r.out_tokens]
            for r in engine.finished}


def port_model(policy, np_params):
    from repro_torch.models import build_model
    from repro_torch.models.convert import convert_params
    cfg = reduce_config(get_config("qwen3-4b")).replace(policy=policy)
    model = build_model(cfg, device="cpu")
    return model, convert_params(np_params, model)


def port_run(kind, policy, np_params, geom, tp=1):
    """One engine run of the port -> (tokens by request, report)."""
    from repro_torch.launch import engine as E
    from repro_torch.serving.spec_decode import SpecConfig
    model, params = port_model(policy, np_params)
    spec = SpecConfig(SPEC_DRAFT, k=2) if kind == "spec" else None
    eng = E.Engine(model, params, E.EngineConfig(**geom, tp=tp),
                   spec=spec, device="cpu")
    reqs = workload(E, kind, model.cfg.vocab_size)
    if kind == "prefix":
        for req in reqs:                # sequential: later ones hit
            eng.run([req])
        rep = eng.report(1.0)
    else:
        rep = eng.run(reqs)
    return tokens_of(eng), rep


REPORT_KEYS = ("tp", "tp_requested", "tp_fallback_reason", "decode_route",
               "verify_route", "draft_route", "prefix_hits",
               "prefix_cow_copies", "tp_wire_bytes_per_step_layer",
               "pool_bytes_allocated_per_device",
               "tp_wire_staged_through_host")


def engine_suite(rank, device, np_params):
    """Every engine run of test_torch_tp.py at the group's width."""
    n = dist.get_world_size()
    out = {}
    for policy in POLICIES:
        out[policy] = port_run("plain", policy, np_params, GEOM, tp=n)
    out["prefix"] = port_run("prefix", PREFIX_POLICY, np_params,
                             PREFIX_GEOM, tp=n)
    out["spec"] = port_run("spec", PREFIX_POLICY, np_params, SPEC_GEOM,
                           tp=n)
    if n == 2:
        out["indivisible"] = port_run("plain", PREFIX_POLICY, np_params,
                                      INDIVISIBLE_GEOM, tp=n)
        out["too_wide"] = port_run("plain", PREFIX_POLICY, np_params, GEOM,
                                   tp=2 * n)
    res = {k: (toks, {key: rep[key] for key in REPORT_KEYS if key in rep})
           for k, (toks, rep) in out.items()}
    if n > 2:
        try:
            port_run("plain", PREFIX_POLICY, np_params, GEOM, tp=n // 2)
            res["narrow"] = ""
        except ValueError as exc:
            res["narrow"] = str(exc)
    return res


# -----------------------------------------------------------------------------
# the pool: sharded writes and the all-gather
# -----------------------------------------------------------------------------

POOL_FORMATS = (("fp4_e2m1", True), ("fp8_e4m3", False), ("fp16", False))


def _pool_pair(fmt, packed, shard, n_pages=7, ps=8, n_kv=2, hd=16):
    """(the whole pool, this rank's slice of it), both zero."""
    full = KV.init_paged_kv_cache(n_pages, ps, n_kv, hd, fmt=fmt,
                                  packed=packed)
    rank, n = shard
    part = {k: v[:, rank * ps // n:(rank + 1) * ps // n].clone()
            for k, v in full.items()}
    return full, part


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


def _pool_equal(full, gathered) -> bool:
    """Byte equality outside the scratch page (page 0 takes the writes a
    rank does not hold, and idle slots' writes, which no request reads)."""
    return all(torch.equal(_bits(full[k][1:]), _bits(gathered[k][1:]))
               for k in KV.QUANT_KEYS)


def pool_suite(rank, device):
    """Writes at every offset across the shard boundaries, decode-step
    tokens and prefill rows, into the whole pool and into the rank's
    slice; after each, the slices all-gathered (`tp._gather_pool`) must
    equal the whole pool byte for byte.  -> [failures]."""
    group = TP.active_group()
    shard = TP.shard()
    ps, n_kv, hd = 8, 2, 16
    fails = []
    for fmt, packed in POOL_FORMATS:
        rng = np.random.default_rng(11)
        full, part = _pool_pair(fmt, packed, shard)
        table = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
        full["block_table"] = part["block_table"] = table
        for s_new in (1, 3):
            for pos0 in range(0, 3 * ps - s_new + 1):
                k = torch.from_numpy(rng.standard_normal(
                    (2, s_new, n_kv, hd)).astype(np.float32))
                v = torch.from_numpy(rng.standard_normal(
                    (2, s_new, n_kv, hd)).astype(np.float32))
                pos = torch.tensor([pos0, 3 * ps - s_new - pos0],
                                   dtype=torch.int32)
                KV.paged_write_tokens(full, k, v, pos, fmt=fmt,
                                      packed=packed)
                KV.paged_write_tokens(part, k, v, pos, fmt=fmt,
                                      packed=packed, shard=shard)
                got = TP._gather_pool({k: part[k] for k in KV.QUANT_KEYS},
                                      group)
                if not _pool_equal(full, got):
                    fails.append(f"{fmt} tokens s_new {s_new} at {pos0}")
        for length in (5, 8, 13, 16, 21):
            for start in range(0, length + 1):
                x = torch.from_numpy(rng.standard_normal(
                    (1, length, n_kv, hd)).astype(np.float32))
                c, s = KV.quantize_kv(x[0], fmt=fmt, packed=packed)
                rows = {"k_codes": c, "k_scale": s, "v_codes": c,
                        "v_scale": s}
                KV.write_prefill_rows(full, rows, [6, 3, 5], length,
                                      start=start)
                KV.write_prefill_rows(part, rows, [6, 3, 5], length,
                                      start=start, shard=shard)
                got = TP._gather_pool({k: part[k] for k in KV.QUANT_KEYS},
                                      group)
                if not _pool_equal(full, got):
                    fails.append(f"{fmt} prefill {length} from {start}")
    return fails


# -----------------------------------------------------------------------------
# flash decoding over sequence-sharded raw caches
# -----------------------------------------------------------------------------

def _tiny(flash_decode):
    from repro_torch.models import ModelConfig, build_model
    cfg = ModelConfig("t", "decoder", 2, 64, 4, 2, 128, 256, policy="fp32",
                      flash_decode=flash_decode)
    return build_model(cfg, device="cpu")


def flash_suite(rank, device):
    """Teacher forcing against `flash_decode` steps over caches sharded
    on the group (S 16, and S 18 where it divides), and the plain path
    where S does not divide -> {case: (max |err|, cache sharded)}."""
    from repro_torch.distributed.sharding import shard_seq_caches
    n = dist.get_world_size()
    model = _tiny(True)
    params = model.init(torch.Generator().manual_seed(0))
    out = {}
    for S, tensor_index in ((16, False), (18, True)):
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, 256, size=(4, S)).astype(np.int64))
        full, _ = model.train_logits(params, {"tokens": toks})
        caches = shard_seq_caches(model, model.init_caches(4, S),
                                  TP.active_group())
        sharded = all("seq_shard" in c for c in caches)
        err = 0.0
        for t in range(S):
            idx = torch.tensor(t, dtype=torch.int32) if tensor_index else t
            lg, caches = model.decode_step(
                params, {"tokens": toks[:, t:t + 1], "index": idx}, caches)
            err = max(err, float((lg[:, 0] - full[:, t]).abs().max()))
        out[f"S{S}"] = (err, sharded, S % n == 0)
    return out


# -----------------------------------------------------------------------------
# collectives: the wire, error feedback, the compressed train step
# -----------------------------------------------------------------------------

WIRE_FORMATS = ("fp16", "fp8_e4m3")
EF_ROUNDS = 30


def _rel(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def collectives_suite(rank, device, x, g, np_params, batch, opt_kw):
    """Rank r holds x[r], g[r] and the batch's row r.  -> the rank's wire
    codes, scales, residual and mean of one `ef_compress_allreduce`
    round; the error-feedback rounds' relative errors; `psum_wire` and
    `all_gather_wire` against the torch f32 `all_reduce` / the exact
    gather; and the compressed train step's loss, params, residual
    magnitude and replica agreement per wire format."""
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.step import (init_err_state,
                                              make_compressed_train_step)
    from repro_torch.models import ModelConfig, build_model
    from repro_torch.models.convert import convert_tree
    from repro_torch.optim import adamw
    group = TP.active_group()
    out = {"wire": {}, "reduce": {}, "gather": {}, "step": {}}
    xr = torch.from_numpy(x[rank])
    for fmt in WIRE_FORMATS:
        err = torch.from_numpy(x[(rank + 1) % len(x)]) * 0.01
        mean, new_err = C.ef_compress_allreduce(xr, err, group, fmt)
        q, s = C.quantize_for_wire(xr + err, fmt)
        out["wire"][fmt] = (_bits(q).numpy(), s.numpy(), new_err.numpy(),
                            mean.numpy(),
                            C.replicas_agree({"mean": mean}, group))
        want = xr.clone()
        dist.all_reduce(want, group=group)                  # torch f32
        out["reduce"][fmt] = _rel(TP.psum_wire(xr, group, fmt), want)
        full = torch.from_numpy(x)
        out["gather"][fmt] = _rel(
            TP.all_gather_wire(xr[None], group, fmt, gather_axis=0), full)
    # the tree form reduces each leaf as the leaf form does
    tree = {"a": xr.clone(), "b": [torch.from_numpy(g[rank]).clone()]}
    errs = {"a": torch.zeros_like(xr), "b": [torch.zeros_like(tree["b"][0])]}
    want = [C.ef_compress_allreduce(x, torch.zeros_like(x), group)
            for x in (tree["a"], tree["b"][0])]
    means, errs = C.tree_compress_allreduce(tree, errs, group)
    out["tree"] = all(torch.equal(m, w[0]) and torch.equal(e, w[1])
                      for m, e, w in zip((means["a"], means["b"][0]),
                                         (errs["a"], errs["b"][0]), want))
    gr = torch.from_numpy(g[rank])
    true_mean = torch.from_numpy(g).mean(dim=0)
    err = torch.zeros_like(gr)
    acc = torch.zeros_like(gr)
    for _ in range(EF_ROUNDS):
        mean, err = C.ef_compress_allreduce(gr, err, group)
        acc += mean
    single, _ = C.ef_compress_allreduce(gr, torch.zeros_like(gr), group)
    out["ef"] = (_rel(single, true_mean), _rel(acc / EF_ROUNDS, true_mean))
    cfg = ModelConfig("t", "decoder", 2, 64, 4, 2, 128, 256)
    model = build_model(cfg, device="cpu")
    mine = {k: torch.from_numpy(v[rank:rank + 1]) for k, v in batch.items()}
    for fmt in (None, "fp8_e4m3"):
        params = convert_tree(np_params, model)
        state = {"params": params, "opt": adamw.init(params),
                 "err": init_err_state(params)}
        step = make_compressed_train_step(model, adamw.AdamWConfig(**opt_kw),
                                          group, fmt_name=fmt)
        state, metrics = step(state, mine)
        out["step"][fmt or "f32"] = {
            "loss": float(metrics["loss"]),
            "params": {"/".join(p): t.detach().numpy().copy() for p, t in
                       _flat(state["params"])} if rank == 0 else None,
            "err_mag": max(float(e.abs().max()) for _, e in
                           _flat(state["err"])),
            "agree": C.replicas_agree(state["params"], group)}
    return out


def _flat(tree):
    from repro_torch.core.tree import flatten_with_paths
    return flatten_with_paths(tree)
