"""Trans-precision collectives in the port (`distributed/collectives.py`,
`tp.psum_wire` / `all_gather_wire`, the `allreduce` routes and
`distributed.step.make_compressed_train_step`), on 8 gloo ranks of the
CPU spawned once for the module (`tests/torch_tp_ranks.py`).

- The wire: each rank's codes and scales equal
  `jax.jit(repro.distributed.collectives.quantize_for_wire)` of its shard
  bit for bit, in fp16 and E4M3, and its residual equals grad + err -
  codes * scale in f32; every rank's mean is the same bits, within n f32
  ulps of the reference's mean of the widened shards.
- Error feedback over 30 rounds at 8 ranks: one round within 0.08 of the
  true mean, the average over rounds within half of that
  (`tests/test_distributed.py:73-107`).
- `psum_wire` and `all_gather_wire` against a torch f32 `all_reduce` and
  the exact gather, at the reference's pins (fp16 2e-3, E4M3 8e-2, and
  the E4M3 wire really lossy).  The reference's own
  `test_wire_collectives_parity` is fault F3 (ROADMAP Queue 3), so the
  port is held against torch's collective instead.
- `make_compressed_train_step` at the bounds of
  `tests/test_distributed.py:199-248` against the reference's jitted
  single-device step on the joined batch: the f32 route's loss within
  1e-4, params within 1e-4 and a zero residual; the E4M3 wire's loss
  within 1e-3, params within 5e-3 and a live residual; both with every
  rank's params bit-identical.
- The `allreduce` routes' `bytes_moved` equal the reference's.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_tp_ranks as R  # noqa: E402
from repro_torch.core import exec_plan  # noqa: E402
from repro_torch.core.tree import flatten_with_paths  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import ModelConfig, build_model  # noqa: E402
from repro_torch.models.convert import convert_tree  # noqa: E402

RC = importlib.import_module("repro.distributed.collectives")
RSTEP = importlib.import_module("repro.distributed.step")
RMODELS = importlib.import_module("repro.models")
RADAMW = importlib.import_module("repro.optim.adamw")
RREG = importlib.import_module("repro.kernels.registry")

N = 8
OPT = dict(lr=1e-3, total_steps=10)


@pytest.fixture(autouse=True)
def _jax_32bit():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def inputs():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (N, 64, 32),
                                     jnp.float32))
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, 1024),
                                     jnp.float32))
    cfg = RMODELS.ModelConfig("t", "decoder", 2, 64, 4, 2, 128, 256)
    rmodel = RMODELS.build_model(cfg)
    rparams = rmodel.init(jax.random.PRNGKey(0))
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (N, 32), 0,
                                          256),
             "labels": jax.random.randint(jax.random.PRNGKey(2), (N, 32), 0,
                                          256)}
    ref_step = RSTEP.make_train_step(rmodel, RADAMW.AdamWConfig(**OPT))
    s_ref, m_ref = jax.jit(ref_step)(
        {"params": rparams, "opt": RADAMW.init(rparams)}, batch)
    np_params = jax.tree.map(np.asarray, rparams)
    ref_params = jax.tree.map(np.asarray, s_ref["params"])
    return dict(x=x, g=g, np_params=np_params,
                batch={k: np.asarray(v).astype(np.int64)
                       for k, v in batch.items()},
                ref_loss=float(m_ref["loss"]), ref_params=ref_params)


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    store = tmp_path_factory.mktemp("coll") / "store"
    return run_ranks(R.collectives_suite, N, backend="gloo", device="cpu",
                     timeout=240, init_method=f"file://{store}", threads=1,
                     args=(inputs["x"], inputs["g"], inputs["np_params"],
                           inputs["batch"], OPT))


@pytest.mark.parametrize("fmt", R.WIRE_FORMATS)
def test_wire_codes_scales_residuals_equal_the_reference(inputs, ranks, fmt):
    x = inputs["x"]
    quant = jax.jit(lambda v: RC.quantize_for_wire(v, fmt))
    widened = []
    for r, res in enumerate(ranks):
        codes, scale, resid, _, _ = res["wire"][fmt]
        g = x[r] + x[(r + 1) % N] * np.float32(0.01)
        rq, rs = quant(jnp.asarray(g))
        rq = np.asarray(rq)
        assert np.array_equal(codes, rq.view(codes.dtype)), (fmt, r)
        assert np.array_equal(scale.view(np.int32),
                              np.asarray(rs).view(np.int32)), (fmt, r)
        want = g - rq.astype(np.float32) * np.asarray(rs)
        assert np.array_equal(resid.view(np.int32),
                              want.view(np.int32)), (fmt, r)
        widened.append(rq.astype(np.float32) * np.asarray(rs))
    ref_mean = np.asarray(jax.jit(lambda w: jnp.mean(w, axis=0))(
        jnp.asarray(np.stack(widened))))
    for res in ranks:
        mean, agree = res["wire"][fmt][3], res["wire"][fmt][4]
        assert agree
        assert np.array_equal(mean.view(np.int32),
                              ranks[0]["wire"][fmt][3].view(np.int32))
        ulp = np.spacing(np.maximum(np.abs(ref_mean), np.float32(1e-30)))
        assert np.all(np.abs(mean - ref_mean) <= N * ulp), fmt


def test_error_feedback_converges_over_rounds(ranks):
    assert all(res["tree"] for res in ranks)     # tree form = leaf form
    for res in ranks:
        rel_single, rel_avg = res["ef"]
        assert rel_single < 0.08, res["ef"]
        assert rel_avg < rel_single / 2, res["ef"]


@pytest.mark.parametrize("fmt,tol", [("fp16", 2e-3), ("fp8_e4m3", 8e-2)])
def test_wire_reductions_against_torch_f32_all_reduce(ranks, fmt, tol):
    for res in ranks:
        assert res["reduce"][fmt] < tol, res["reduce"]
        assert res["gather"][fmt] < tol, res["gather"]
    assert ranks[0]["reduce"]["fp8_e4m3"] > 1e-6     # lossy, not exact


@pytest.mark.parametrize("route", ["f32", "fp8_e4m3"])
def test_compressed_train_step_bounds_and_replicas(inputs, ranks, route):
    got = [res["step"][route] for res in ranks]
    assert all(r["agree"] for r in got), route
    assert len({r["loss"] for r in got}) == 1, route
    model = build_model(ModelConfig("t", "decoder", 2, 64, 4, 2, 128, 256),
                        device="cpu")
    want = {"/".join(p): t.numpy() for p, t in flatten_with_paths(
        convert_tree(inputs["ref_params"], model))}
    params = got[0]["params"]
    assert set(params) == set(want)
    diff = max(float(np.abs(params[k] - want[k]).max()) for k in want)
    loss_err = abs(got[0]["loss"] - inputs["ref_loss"])
    if route == "f32":
        assert loss_err < 1e-4 and diff < 1e-4, (loss_err, diff)
        assert all(r["err_mag"] == 0.0 for r in got)
    else:
        assert loss_err < 1e-3 and diff < 5e-3, (loss_err, diff)
        assert all(r["err_mag"] > 0.0 for r in got)


@pytest.mark.parametrize("wire_fmt,route", [("fp8_e4m3", "wire_compressed"),
                                            ("fp16", "wire_compressed"),
                                            (None, "torch_psum_f32")])
def test_allreduce_routes_price_the_reference_bytes(wire_fmt, route):
    ctx = dict(wire_fmt=wire_fmt, n_devices=N, size=123457)
    d = exec_plan.describe("allreduce", None, **ctx)
    assert d["route"] == route
    ref = {"wire_compressed": "wire_compressed",
           "torch_psum_f32": "xla_psum_f32"}[route]
    want = RREG.exec_plan.route("allreduce", ref).bytes_moved(None, ctx)
    assert d["bytes_moved"] == want
    one = exec_plan.resolve("allreduce", None, wire_fmt=wire_fmt,
                            n_devices=1)
    assert one.name == "torch_psum_f32"
