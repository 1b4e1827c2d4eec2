"""chip_smoke.py's checks of the kernels' trans-precision formats alone,
on the card.

    python3 tools/formats_probe.py [SECTION ...]

Builds the kernels, then runs phase 2's format checks: the fused matmul
with E2M1 and fp16 activations (`check_fused_formats`), paged decode in
every new (attention, KV) pair and its verify fold at both models'
engine shapes (`check_paged_formats`, `check_verify_fold`), and DPA
flash in fp16 and E2M1 attention (`check_dpa_flash_formats`), then
paths L, M and N on full-width qwen3-4b and granite-moe-1b
(`run_format_paths`).  SECTIONs (fused, paged, flash, paths) pick some;
none runs all.  Prints the card's name and power limit, each check's
lines and the section times.  Needs a CUDA card.
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
    for line in build.BUILD_INFO["log"].splitlines():
        if line.startswith("=="):
            print("  " + line.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    qwen = get_config("qwen3-4b").replace(policy="w4a8_kv4_attn8")
    granite = get_config("granite-moe-1b-a400m").replace(
        policy="w4a8_kv4_attn8")
    ecfg = EngineConfig(page_size=16, n_pages=80, max_batch=4,
                        max_pages_per_req=16, token_budget=64,
                        prefill_chunk=32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    want = set(sys.argv[1:]) or {"fused", "paged", "flash", "paths"}
    times, out = {}, {}
    for section, name, fn in (
            ("fused", "fused",
             lambda: cs.check_fused_formats(qwen, granite, gen)),
            ("paged", "paged hd128",
             lambda: cs.check_paged_formats(qwen, gen, ecfg)),
            ("paged", "paged hd64",
             lambda: cs.check_paged_formats(granite, gen, ecfg)),
            ("paged", "fold hd128",
             lambda: cs.check_verify_fold(qwen, gen, ecfg)),
            ("paged", "fold hd64",
             lambda: cs.check_verify_fold(granite, gen, ecfg)),
            ("flash", "dpa flash", lambda: cs.check_dpa_flash_formats(gen)),
            ("paths", "paths",
             lambda: cs.run_format_paths(qwen, granite, ecfg))):
        if section not in want:
            continue
        t0 = time.monotonic()
        out[name] = fn()
        times[name] = time.monotonic() - t0
        print(f"{name}: {times[name]:.1f} s")
    print("formats: " + json.dumps(out, default=str))
    print("times: " + json.dumps(times))


if __name__ == "__main__":
    main()
