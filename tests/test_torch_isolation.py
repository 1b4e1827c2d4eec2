"""The port stands alone: no module of `repro_torch` (nor chip_smoke.py)
imports JAX or the reference package — its serving paths and a
supervised training run go through without them — and the entry points
run on the card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_SCRIPT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of these now raises
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import numpy as np, torch
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
from repro_torch.configs import get_config, reduce_config
from repro_torch.launch.engine import Engine, EngineConfig, Request
from repro_torch.models import build_model
cfg = reduce_config(get_config("qwen3-4b")).replace(policy="w4a8_kv4_attn8")
model = build_model(cfg, device="cpu")
params = model.init(torch.Generator().manual_seed(0))
engine = Engine(model, params, EngineConfig(page_size=8, n_pages=8,
                max_batch=2, max_pages_per_req=2, prefill_chunk=8),
                device="cpu")
rep = engine.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                          max_new=3)])
assert rep["gen_tokens"] == 3 and engine.alloc.in_use == 0
# the MoE slice: both granite paths, engine (grouped fused) and generate
# (dense and grouped prequant)
from repro_torch.launch.serve import generate
moe = reduce_config(get_config("granite-moe-1b-a400m"))
model = build_model(moe.replace(policy="w4a8_kv4_attn8"), device="cpu")
params = model.init(torch.Generator().manual_seed(0))
engine = Engine(model, params, EngineConfig(page_size=8, n_pages=8,
                max_batch=2, max_pages_per_req=2, prefill_chunk=8),
                device="cpu")
rep = engine.run([Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                          max_new=3)])
assert rep["moe_grouped_route"] == "cuda_grouped_fused", rep
model = build_model(moe.replace(policy="fp4_dpa_packed"), device="cpu")
out = generate(model, model.init(torch.Generator().manual_seed(0)),
               np.arange(4)[None], 2, 8, device="cpu")
assert tuple(out.shape) == (1, 6)
# slice 3: long-prompt prefill (f32 flash) and full-sequence scoring (DPA
# flash), through the step builders
from repro_torch.distributed.step import make_loss_fn, make_prefill_step
qwen = reduce_config(get_config("qwen3-4b")).replace(use_flash=True)
model = build_model(qwen, device="cpu")
toks = torch.arange(32)[None] % qwen.vocab_size
logits, _ = make_prefill_step(model)(model.init(torch.Generator()
                                                .manual_seed(0)), toks)
assert tuple(logits.shape) == (1, 1, qwen.vocab_size)
model = build_model(qwen.replace(policy="w4a8_kv4_attn8"), device="cpu")
total, parts = make_loss_fn(model)(model.init(torch.Generator()
                                              .manual_seed(0)),
                                   {"tokens": toks, "labels": toks})
assert bool(torch.isfinite(total)) and float(parts["aux"]) == 0.0
# slice 14: training — the pipeline, two supervised train steps with a
# checkpoint and an injected failure, and the reference's state layout
import tempfile
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.distributed.step import make_train_step
from repro_torch.launch.train import build_state
from repro_torch.optim import adamw
from repro_torch.runtime.fault import Supervisor, SupervisorConfig
moe = moe.replace(policy="fp8_dpa", remat="full", attn_chunk=8,
                  logits_chunk=8)
model = build_model(moe, device="cpu")
step = make_train_step(model, adamw.AdamWConfig(warmup_steps=1,
                                                total_steps=3))
pipe = make_pipeline(DataConfig(vocab_size=moe.vocab_size, batch=2, seq=16),
                     device="cpu")
with tempfile.TemporaryDirectory() as d:
    sup = Supervisor(SupervisorConfig(ckpt_dir=d, ckpt_every=1),
                     state=build_state(model, 0))
    sup.inject_failure_at = 2
    state = sup.run(step, pipe.batch, 3)
assert int(state["opt"]["count"]) == 3 and sup.events[1] == ("restored", 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
             and sys.modules[m] is not None)
assert not bad, bad
print("modules", len(names))
"""


def test_port_imports_and_serves_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[-1]) >= 55


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_file_names_jax_or_the_reference():
    files = list(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        roots = set(_imported_roots(f))
        assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, f


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.engine import Engine, EngineConfig
    from repro_torch.launch.serve import generate
    from repro_torch.models import build_model
    cfg = reduce_config(get_config("qwen3-4b")).replace(
        policy="kv4_attn8_packed")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(reduce_config(get_config("granite-moe-1b-a400m")))
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(model, None, EngineConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(model, None, torch.zeros((1, 2), dtype=torch.int64), 1, 8)
    from repro_torch.launch.train import main as train_main
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", "qwen3-4b", "--reduced", "--steps", "1"])
