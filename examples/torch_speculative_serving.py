"""Self-speculative serving walkthrough on the PyTorch port: draft in fp4,
verify exactly (the counterpart of `examples/speculative_serving.py`).

TransDot's reconfigurable datapath runs the *same weights* at
fp16/fp8/fp4 operand width with 2x/4x/8x DPA throughput (Table I).
Speculative decoding turns that range into a serving win without
touching output quality:

  1. draft  — k tokens per request under `w4a4_kv4_attn4` (fp4-grid
     linears and attention: the 8-term DPA route end to end);
  2. verify — one batched pass under the serving policy scores all k+1
     positions through the `verify_attn` route (the paged decode kernel's
     verify fold on the card), each row bit-identical to a plain decode
     step at that position: what picks its order by the number of rows
     runs one query row at a time (`repro_torch.models.layers`);
  3. accept — greedy prefix match (rejection sampling when a temperature
     is set), so greedy outputs are exactly the serving policy's: the
     walkthrough asserts token-for-token identity against the plain
     engine.

Both policies share one packed-fp4 page pool; the verify pass rewrites
every draft-touched row with serving-policy codes, and pages holding
only rejected rows roll back to the request's reservation.

Run on the card (qwen3-4b at full width, seeded random weights; the
steps run as CUDA graphs):

    PYTHONPATH=src python examples/torch_speculative_serving.py

or on the CPU at reduced size:

    PYTHONPATH=src python examples/torch_speculative_serving.py \
        --device cpu --reduced
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.launch.engine import (Engine, EngineConfig,  # noqa: E402
                                       format_report, synthetic_workload)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.sampler import SamplerConfig  # noqa: E402
from repro_torch.serving.spec_decode import SpecConfig  # noqa: E402

DRAFT, VERIFY, K = "w4a4_kv4_attn4", "kv4_attn8_packed", 3


def _workload(vocab):
    return synthetic_workload(8, vocab=vocab, seed=0, prompt_range=(6, 24),
                              gen_range=(4, 10))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config (head dim 16: the CPU only)")
    args = ap.parse_args(argv)
    cfg = get_config("qwen3-4b").replace(policy=VERIFY)
    if args.reduced:
        cfg = reduce_config(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=args.device).manual_seed(0))
    ecfg = EngineConfig(page_size=8, n_pages=48, max_batch=4,
                        max_pages_per_req=6, token_budget=16,
                        prefill_chunk=8)
    print(f"draft {K} tokens/round under {DRAFT} (8-term fp4 DPA), "
          f"verify under {VERIFY}, on {args.device}\n")

    plain = Engine(model, params, ecfg, device=args.device)
    plain.run(_workload(cfg.vocab_size))

    spec = Engine(model, params, ecfg, device=args.device,
                  spec=SpecConfig(DRAFT, k=K))
    rep = spec.run(_workload(cfg.vocab_size))
    print(format_report(rep, VERIFY))

    # the exactness claim: greedy speculative == plain engine, per request
    print("\nper-request outputs vs the plain (non-speculative) engine:")
    want = {r.rid: r.out_tokens for r in plain.finished}
    got = {r.rid: r.out_tokens for r in spec.finished}
    for rid in sorted(want)[:5]:
        same = got[rid] == want[rid]
        print(f"  req {rid}: "
              f"{'token-for-token identical' if same else 'MISMATCH'} "
              f"{got[rid][:6]}")
    assert got == want, "speculative tokens differ from the plain engine's"

    # sampled mode: the target's distribution, keyed per request
    smp = SamplerConfig(temperature=0.8, top_k=16, top_p=0.95, seed=7)
    sampled = Engine(model, params, ecfg, device=args.device, sampler=smp,
                     spec=SpecConfig(DRAFT, k=K))
    srep = sampled.run(_workload(cfg.vocab_size))
    print(f"\nsampled (T={smp.temperature}, top-k {smp.top_k}, top-p "
          f"{smp.top_p}): acceptance {srep['acceptance_rate']:.0%}, "
          f"{srep['eff_tokens_per_round']:.2f} effective tokens/round "
          f"(rejection sampling keeps the output distribution exactly "
          f"the serving policy's)")
    # sampled mode rejects (and rolls back) hardest: check both engines
    for eng in (spec, sampled):
        assert eng.alloc.in_use == 0 and eng.alloc.reserved == 0
    print("\nallocator drained clean: no leaked pages, reservations "
          "balanced after every rollback")
    return {"plain": want, "spec": got, "spec_report": rep,
            "sampled_report": srep}


if __name__ == "__main__":
    main()
