"""The port's examples, each run once on the CPU at reduced size.

`examples/torch_speculative_serving.py` (the counterpart of the
reference's `examples/speculative_serving.py`): its greedy speculative
engine gives the plain engine's tokens for every request (the identity
the reference's walkthrough asserts), its sampled run drains, and it
prints the reference's report lines.
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops lose
    most of their time to thread hand-offs when test workers share the
    cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_speculative_serving_walkthrough(capsys):
    ex = _load("torch_speculative_serving")
    out = ex.main(["--device", "cpu", "--reduced"])
    assert out["spec"] == out["plain"] and len(out["plain"]) == 8
    rep = out["spec_report"]
    assert rep["spec_draft_policy"] == ex.DRAFT and rep["spec_k"] == ex.K
    assert rep["spec_rounds"] > 0 and 0.0 <= rep["acceptance_rate"] <= 1.0
    assert out["sampled_report"]["n_requests"] == 8
    text = capsys.readouterr().out
    assert "token-for-token identical" in text and "MISMATCH" not in text
    assert "allocator drained clean" in text
