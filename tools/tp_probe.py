"""chip_smoke.py's phase 6 (tensor parallelism) alone, on the card.

    python3 tools/tp_probe.py

Builds the kernels, then runs `chip_smoke.run_tp` at phase 3a's engine
geometry: the tp=1 eager engine on phase 6's runs, then two gloo ranks
sharing the card that serve the same runs at tp 2 and step the
compressed train step on both routes (each checked as phase 6 checks
it).  Prints the card's name and power limit, the phase's lines and its
JSON (~200 s of command time with the build).  Needs a CUDA card.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.engine import EngineConfig

    print("card:", cs.card_line(), torch.__version__, torch.version.cuda)
    t0 = time.monotonic()
    build.load_library()
    print(f"kernel build: {time.monotonic() - t0:.1f} s")
    torch.backends.cuda.matmul.allow_tf32 = False
    qwen = get_config("qwen3-4b").replace(policy="w4a8_kv4_attn8")
    ecfg = EngineConfig(page_size=16, n_pages=80, max_batch=4,
                        max_pages_per_req=16, token_budget=64,
                        prefill_chunk=32)
    t0 = time.monotonic()
    out = cs.run_tp(qwen, ecfg)
    print(f"phase 6: {time.monotonic() - t0:.1f} s")
    print("tp: " + json.dumps(out))


if __name__ == "__main__":        # spawned ranks re-import this file
    main()
