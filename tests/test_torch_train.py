"""The port's training path against the reference's under `jax.jit`, on
reduced qwen3-4b, llama3.2-3b and granite-moe-1b (weights converted from
the reference's init), and its bit-for-bit contracts inside the port.

  loss and gradients   `value_and_grad(make_loss_fn)` against
                       `jax.value_and_grad(make_loss_fn)`, fp32 and
                       fp8_dpa, the cross-entropy whole (logits_chunk 0)
                       and in 8-token chunks with 8-query attention
                       blocks (attn_chunk 8), B 2 x S 32: fp32 loss rtol
                       1e-5 and each gradient leaf's relative norm error
                       <= 1e-4; fp8_dpa loss rtol 1e-4 and leaves <= 1e-3
                       (an STE code can flip at a rounding boundary).
  inside the port      remat none, full, dots and remat_block 2 give equal
                       losses and gradients bit for bit; attn_chunk gives
                       the unchunked logits and loss bit for bit (its K/V
                       gradients sum the blocks in another order: held
                       at relative norm 1e-6).
  refusals             kernel policies and use_flash are refused by
                       `make_train_step` and `launch.train`; every kernel
                       wrapper refuses an input that requires grad before
                       it loads anything.
  front end            `launch.train.main([... "--reduced", "--device",
                       "cpu"])` prints its step and done lines.
  STE replay           chip_smoke.py's hook on the fake-quant routes
                       (phase 5 (a)): a step replayed from its own
                       recorded operands equals it bit for bit, a moved
                       code and a moved scale count once each and move
                       the gradients, and a record that does not pair up
                       with the calls raises.

Measured worst: losses 8.5e-8 relative, gradient leaves 2.0e-6 (fp32)
and 9.3e-7 (fp8_dpa); attn_chunk's gradient leaves 3.7e-7.  Five train
steps against the reference's are tests/test_torch_train_steps.py.
"""
import functools
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.distributed import step as TS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import train as TT  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import (convert_params,  # noqa: E402
                                        convert_tree)
from repro_torch.optim import adamw  # noqa: E402

RCFG = importlib.import_module("repro.configs")
RMODELS = importlib.import_module("repro.models")
RSTEP = importlib.import_module("repro.distributed.step")

ARCHS = ("qwen3-4b", "llama3.2-3b", "granite-moe-1b-a400m")
B, S = 2, 32
TOL = {"fp32": dict(loss=1e-5, leaf=1e-4),
       "fp8_dpa": dict(loss=1e-4, leaf=1e-3)}
CHUNKS = {"whole": dict(logits_chunk=0, attn_chunk=0),
          "chunked": dict(logits_chunk=8, attn_chunk=8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs: its many small ops lose
    most of their time to thread hand-offs when test workers share the
    cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_32bit():
    """The reference under 32-bit JAX, its training setting: a module
    imported earlier in the same process may have turned x64 on
    (`repro.core.dpa` does on import)."""
    with jax.enable_x64(False):
        yield


@functools.lru_cache(maxsize=None)
def _pair(arch, policy, chunks):
    kw = dict(policy=policy, **CHUNKS[chunks])
    rcfg = RCFG.reduce_config(RCFG.get_config(arch)).replace(**kw)
    rmodel = RMODELS.build_model(rcfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(reduce_config(get_config(arch)).replace(**kw),
                         device="cpu")
    return rmodel, rparams, tmodel


def _params(tmodel, rparams):
    return convert_params(jax.tree.map(np.asarray, rparams), tmodel)


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(B, S))
    labels = rng.integers(0, vocab, size=(B, S))
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labels)})


def _leaf_errors(got, want):
    """{path: ||got - want|| / ||want||} over two trees of the port's
    structure."""
    out = {}
    for (path, a), (_, b) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want)):
        a, b = a.detach(), b.detach()
        out[path] = float((a - b).norm() / max(float(b.norm()), 1e-30))
    return out


@pytest.mark.parametrize("chunks", list(CHUNKS))
@pytest.mark.parametrize("policy", list(TOL))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, policy, chunks):
    rmodel, rparams, tmodel = _pair(arch, policy, chunks)
    jb, tb = _batch(tmodel.cfg.vocab_size)
    (want, wparts), wgrads = jax.jit(jax.value_and_grad(
        RSTEP.make_loss_fn(rmodel), has_aux=True))(rparams, jb)
    (got, parts), grads = TS.value_and_grad(TS.make_loss_fn(tmodel))(
        _params(tmodel, rparams), tb)
    tol = TOL[policy]
    np.testing.assert_allclose(float(got), float(want), rtol=tol["loss"])
    np.testing.assert_allclose(float(parts["aux"]), float(wparts["aux"]),
                               rtol=tol["loss"], atol=1e-7)
    errs = _leaf_errors(grads, convert_tree(jax.tree.map(np.asarray, wgrads),
                                            tmodel))
    worst = max(errs, key=errs.get)
    print(f"{arch} {policy} {chunks}: loss {abs(float(got) / float(want) - 1):.1e}"
          f", worst leaf {errs[worst]:.1e} at {'.'.join(worst)}")
    assert errs[worst] <= tol["leaf"], worst


def _grads(cfg, seed=0):
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    _, tb = _batch(cfg.vocab_size, seed)
    (total, parts), grads = TS.value_and_grad(TS.make_loss_fn(model))(
        params, tb)
    return total, parts, grads


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-1b-a400m"])
def test_remat_variants_bit_for_bit(arch):
    base = reduce_config(get_config(arch)).replace(
        n_layers=4, policy="fp8_dpa", logits_chunk=8, attn_chunk=8)
    ref_total, ref_parts, ref = _grads(base)
    for remat, block in (("full", 0), ("dots", 0), ("full", 2), ("dots", 2)):
        total, parts, grads = _grads(base.replace(remat=remat,
                                                  remat_block=block))
        assert torch.equal(parts["loss"], ref_parts["loss"]), (remat, block)
        assert torch.equal(total, ref_total), (remat, block)
        for (path, a), (_, b) in zip(flatten_with_paths(grads),
                                     flatten_with_paths(ref)):
            assert torch.equal(a, b), (remat, block, path)


def test_dots_keeps_the_products():
    """remat="dots" saves the outputs of `mm` (what cuBLAS runs on the
    card) and recomputes the rest; "full" recomputes the mm too."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.models import transformer as T

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    w = torch.randn(8, 8, requires_grad=True)
    x = torch.randn(4, 8, requires_grad=True)
    cfg = reduce_config(get_config("qwen3-4b"))
    counts = {}
    for remat in ("full", "dots"):
        fn = T._remat(lambda x: torch.sin(torch.mm(x, w)), cfg.replace(
            remat=remat))
        y = fn(x).sum()
        with Count() as c:
            y.backward()
        counts[remat] = c.mm
    assert counts == {"full": 3, "dots": 2}, counts


@pytest.mark.parametrize("policy", list(TOL))
def test_attn_chunk_equals_unchunked(policy):
    base = reduce_config(get_config("qwen3-4b")).replace(policy=policy,
                                                         logits_chunk=0)
    model = build_model(base, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    _, tb = _batch(base.vocab_size)
    outs = {}
    for ac in (0, 8):
        m = build_model(base.replace(attn_chunk=ac), device="cpu")
        with torch.no_grad():
            logits, _ = m.train_logits(params, tb)
        (total, _), grads = TS.value_and_grad(TS.make_loss_fn(m))(params, tb)
        outs[ac] = logits, total, grads
    assert torch.equal(outs[8][0], outs[0][0])
    assert torch.equal(outs[8][1], outs[0][1])
    errs = _leaf_errors(outs[8][2], outs[0][2])
    print(f"{policy}: worst leaf {max(errs.values()):.1e}")
    assert max(errs.values()) <= 1e-6


KERNEL_POLICIES = ("w4a8_kv4_attn8", "fp8_dpa_fused", "fp4_dpa_packed")


@pytest.mark.parametrize("policy", KERNEL_POLICIES)
def test_train_step_refuses_kernel_routes(policy):
    cfg = reduce_config(get_config("granite-moe-1b-a400m")).replace(
        policy=policy)
    with pytest.raises(NotImplementedError, match="Backward passes"):
        TS.make_train_step(build_model(cfg, device="cpu"),
                           adamw.AdamWConfig())
    flash = reduce_config(get_config("qwen3-4b")).replace(use_flash=True)
    with pytest.raises(NotImplementedError, match="flash"):
        TS.make_train_step(build_model(flash, device="cpu"),
                           adamw.AdamWConfig())
    with pytest.raises(NotImplementedError, match="collectives"):
        TS.make_compressed_train_step(None, adamw.AdamWConfig(), None)


def _wrapper_calls():
    from repro_torch.kernels import dpa_grouped_matmul as GM
    from repro_torch.kernels import dpa_matmul as DM
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_decode as PD
    from repro_torch.kernels import quantize as QZ

    def g(*shape):
        return torch.randn(*shape, requires_grad=True)
    w8 = torch.zeros(128, 16, dtype=torch.float8_e4m3fn)
    sw = torch.ones(1, 16)
    fp8 = dict(fmt_x="fp8_e4m3", fmt_w="fp8_e4m3")
    return {
        "dpa_matmul_fused": lambda: DM.dpa_matmul_fused(g(4, 128), w8, sw,
                                                        **fp8),
        "dpa_act_quant": lambda: DM.dpa_act_quant(g(4, 128)),
        "dpa_matmul_prequant": lambda: DM.dpa_matmul_prequant(
            torch.zeros(4, 128, dtype=torch.float8_e4m3fn), w8, g(4, 1), sw,
            **fp8),
        "dpa_grouped_matmul_fused": lambda: GM.dpa_grouped_matmul_fused(
            g(2, 4, 128), w8.expand(2, 128, 16).contiguous(),
            sw.expand(2, 1, 16).contiguous(), **fp8),
        "dpa_grouped_matmul_prequant": lambda:
            GM.dpa_grouped_matmul_prequant(
                torch.zeros(2, 4, 128, dtype=torch.float8_e4m3fn),
                w8.expand(2, 128, 16).contiguous(), g(2, 4, 1),
                sw.expand(2, 1, 16).contiguous(), **fp8),
        "flash_attention": lambda: FA.flash_attention(
            g(1, 2, 8, 64), g(1, 2, 8, 64), g(1, 2, 8, 64)),
        "dpa_flash_attention": lambda: FA.dpa_flash_attention(
            g(1, 2, 8, 64), g(1, 2, 8, 64), g(1, 2, 8, 64), fmt="fp8_e4m3"),
        "paged_decode_attention": lambda: PD.paged_decode_attention(
            g(1, 1, 2, 64), None, None, None, None, None, None,
            fmt="fp8_e4m3", fmt_kv="fp8_e4m3"),
        "quantize_rows": lambda: QZ.quantize_rows(g(4, 64), fmt="fp8_e4m3"),
        "quantize_pack_rows": lambda: QZ.quantize_pack_rows(g(4, 64)),
    }


@pytest.mark.parametrize("name", list(_wrapper_calls()))
def test_kernel_wrappers_refuse_autograd(name):
    call = _wrapper_calls()[name]
    lib = build._LIB
    with pytest.raises(NotImplementedError, match="Backward passes"):
        call()
    assert build._LIB is lib                  # nothing loaded or built


def test_front_end_trains_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "6",
            "--batch", "2", "--seq", "16", "--ckpt-every", "3",
            "--log-every", "2", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    state = TT.main(argv)
    out = capsys.readouterr().out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["0", "2", "4"]
    assert "done: 6 steps" in out and "tok/s" in out
    assert int(state["opt"]["count"]) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000002", "step_00000005"]
    with pytest.raises(SystemExit):
        TT.main(argv + ["--n-model", "2"])
    with pytest.raises(NotImplementedError, match="Backward passes"):
        TT.main(argv + ["--policy", "w4a8_kv4_attn8"])


def test_ste_replay_recomputes_a_step_from_given_operands():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    cfg = reduce_config(get_config("llama3.2-3b")).replace(
        policy="fp8_dpa", attn_chunk=8, logits_chunk=8)
    model = build_model(cfg, device="cpu")
    state = TT.build_state(model, 0)
    _, batch = _batch(cfg.vocab_size)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)

    def step(**kw):
        with CS.ste_operands(**kw):
            return CS.train_step_once(model, state, batch, opt)

    def trees_equal(a, b):
        return a[0] == b[0] and all(
            torch.equal(x, y) for t in (1, 2)
            for (_, x), (_, y) in zip(flatten_with_paths(a[t]),
                                      flatten_with_paths(b[t])))

    rec = []
    ref = step(record=rec)
    assert len(rec) > 0 and set(CS.ste_flips(rec, rec).values()) \
        == {0, len(rec), sum(c.numel() for c, _, _ in rec)}
    assert trees_equal(step(replay=rec), ref)
    moved = [tuple(t.clone() for t in r) for r in rec]
    codes, scales, op = moved[len(moved) // 2]
    i = int(torch.nonzero(codes.reshape(-1))[0])
    codes.view(-1)[i] *= 1.125                   # one E4M3 step up
    op.view(-1)[i] *= 1.125
    scales.view(-1)[0] *= 1 + 2 ** -23           # a scale's last bit
    flips = CS.ste_flips(moved, rec)
    assert [flips[k] for k in ("codes", "code_calls", "scales",
                               "scale_calls", "operands")] == [1, 1, 1, 1, 1]
    assert not trees_equal(step(replay=moved), ref)
    with pytest.raises(AssertionError, match="STE replay"):
        step(replay=rec[:-1])
