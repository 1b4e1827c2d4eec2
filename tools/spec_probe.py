"""chip_smoke.py's phase 3j speculation off the split-K route, alone, on
the card.

    python3 tools/spec_probe.py [pairs] [tune] [moe] [example]

Builds the kernels, then on full-width qwen3-4b under `w4a8_kv4_attn8`
(phase 3a's geometry and seeded weights): `pairs` runs
`chip_smoke.run_spec_policies` (the row-invariance probe and the plain
and speculative graphed engines under each of the reference's (draft,
verify) policy pairs at k 3, then the 160-row verify at --max-batch 32
--spec-k 4); `tune` the tuner's engine pseudo-op with its speculative
points (`chip_smoke.tune_engine`); `example` runs
`examples/torch_speculative_serving.py` on the card.  On full-width
granite-moe-1b: `moe` runs `chip_smoke.run_moe_spec` (the probe, a
static fp4 draft, a self-draft and the default ladder).  No argument:
all four.  Prints the card's name and power limit, each part's lines,
seconds and JSON.  Needs a CUDA card.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

PARTS = ("pairs", "tune", "moe", "example")


def main(argv) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.engine import EngineConfig

    parts = [a for a in argv if a in PARTS] or list(PARTS)
    print("card:", cs.card_line(), torch.__version__, torch.version.cuda)
    t0 = time.monotonic()
    build.load_library()
    print(f"kernel build: {time.monotonic() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    ecfg = EngineConfig(page_size=16, n_pages=80, max_batch=4,
                        max_pages_per_req=16, token_budget=64,
                        prefill_chunk=32)
    out, seconds = {}, {}
    if {"pairs", "tune"} & set(parts):
        qwen = get_config("qwen3-4b").replace(policy="w4a8_kv4_attn8")
        _, params = cs.build(qwen)
        if "tune" in parts:
            t0 = time.monotonic()
            out["tune"] = cs.tune_engine(qwen, params)
            seconds["tune"] = time.monotonic() - t0
        if "pairs" in parts:
            t0 = time.monotonic()
            out["pairs"] = cs.run_spec_policies(qwen, ecfg, params)[0]
            seconds["pairs"] = time.monotonic() - t0
        del params
        gc.collect()
        torch.cuda.empty_cache()
    if "moe" in parts:
        granite = get_config("granite-moe-1b-a400m").replace(
            policy="w4a8_kv4_attn8")
        model, params = cs.build(granite)
        t0 = time.monotonic()
        out["moe"] = cs.run_moe_spec(granite, ecfg, model, params)[0]
        seconds["moe"] = time.monotonic() - t0
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
    if "example" in parts:
        path = ROOT / "examples" / "torch_speculative_serving.py"
        spec = importlib.util.spec_from_file_location("example", path)
        ex = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(ex)
        t0 = time.monotonic()
        res = ex.main([])
        seconds["example"] = time.monotonic() - t0
        out["example"] = {"tokens_equal_plain": res["spec"] == res["plain"],
                          "acceptance_rate":
                              res["spec_report"]["acceptance_rate"],
                          "tokens_per_s": res["spec_report"]["tokens_per_s"]}
    print("seconds: " + json.dumps(seconds))
    print("spec probe: " + json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
