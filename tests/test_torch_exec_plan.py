"""The port's routing table: which route serves each op of the slice,
and that no environment variable turns a kernel route off."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import exec_plan  # noqa: E402


def test_selection_pins():
    pins = [
        ("matmul", "fp32", dict(w_dtype="float32"), "torch_f32"),
        ("matmul", "kv4_attn8_packed", dict(w_dtype="float32"), "torch_f32"),
        ("matmul", "fp8_dpa", dict(w_dtype="float32"), "torch_fake_quant"),
        ("matmul", "w4a8_kv4_attn8", dict(w_dtype="float32"), "cuda_fused"),
        ("matmul", "fp8_dpa_fused", dict(w_dtype="bfloat16"), "cuda_fused"),
        ("matmul", "fp4_dpa_packed", dict(w_dtype="float32"),
         "cuda_prequant"),
        ("grouped_matmul", "w4a8_kv4_attn8",
         dict(w_dtype="float32", eq="becd,edf->becf"), "cuda_grouped_fused"),
        ("grouped_matmul", "fp4_dpa_packed",
         dict(w_dtype="float32", eq="gti,gio->gto"),
         "cuda_grouped_prequant"),
        ("grouped_matmul", "w4a8_kv4_attn8",
         dict(w_dtype="float32", eq="bcd,df->bcf"), "torch_fake_quant"),
        ("grouped_matmul", "fp32", dict(w_dtype="float32",
                                        eq="becd,edf->becf"), "torch_f32"),
        ("flash_attn", "fp32", dict(sq=16, skv=16), "torch_ref_attn"),
        ("flash_attn", "w4a8_kv4_attn8", dict(sq=32, skv=256,
                                              kv_on_grid=True),
         "torch_dpa_attn"),
        # use_flash: the flash kernels serve a prefill with no extra key
        # mask; the DPA one only over raw K/V (a quantized cache's values
        # are already on the grid)
        ("flash_attn", "fp8_dpa", dict(sq=16, skv=16, use_flash=True),
         "cuda_f32_flash"),
        ("flash_attn", "w4a8_kv4_attn8", dict(sq=16, skv=16,
                                              use_flash=True),
         "cuda_dpa_flash"),
        ("flash_attn", "w4a8_kv4_attn8", dict(sq=16, skv=16, use_flash=True,
                                              kv_on_grid=True),
         "torch_dpa_attn"),
        ("flash_attn", "fp8_dpa", dict(sq=1, skv=16, use_flash=True),
         "torch_ref_attn"),
        ("flash_attn", "fp8_dpa", dict(sq=16, skv=16, use_flash=True,
                                       has_valid=True), "torch_ref_attn"),
        ("decode_attn", "kv4_attn8_packed", {}, "torch_dpa_decode"),
        ("paged_decode", "w4a8_kv4_attn8", {}, "cuda_block_table"),
        ("unembed", None, {}, "torch_tied_table"),
    ]
    for op, pol, ctx, want in pins:
        assert exec_plan.resolve(op, pol, **ctx).name == want, (op, pol)


def test_raw_cache_policy_has_no_paged_route():
    with pytest.raises(exec_plan.PlanError, match="kv_quantized"):
        exec_plan.resolve("paged_decode", "fp32")


def test_no_environment_switch(monkeypatch):
    for var in ("REPRO_PAGED_KERNEL", "REPRO_TUNED", "REPRO_TUNED_DB"):
        monkeypatch.setenv(var, "0")
    assert exec_plan.resolve("paged_decode",
                             "kv4_attn8_packed").name == "cuda_block_table"
    assert exec_plan.resolve("matmul", "w4a8_kv4_attn8",
                             w_dtype="float32").name == "cuda_fused"


def test_describe_and_table_integrity():
    d = exec_plan.describe("paged_decode", "w4a8_kv4_attn8", batch=4,
                           page_size=16, max_pages=16, kv_heads=8, hd=128)
    assert d["route"] == "cuda_block_table" and d["backend"] == "cuda"
    assert d["reference"] == "torch_gather"
    # packed fp4 codes + f32 scales, K and V, over 4 x 256 rows x 8 heads
    assert d["bytes_moved"] == 2 * (4 * 256 * 8 * (64 + 4))
    assert set(d["candidates"]) == {"cuda_block_table", "torch_gather"}
    assert set(exec_plan.ops()) == {"matmul", "grouped_matmul",
                                    "flash_attn", "decode_attn",
                                    "paged_decode", "verify_attn",
                                    "unembed", "quantize_pack"}
    for op in exec_plan.ops():
        for e in exec_plan.candidates(op):
            ref = exec_plan.reference_entry(e)
            assert ref is None or ref.op == op
    with pytest.raises(ValueError, match="twice"):
        exec_plan.register("unembed", "torch_tied_table", backend="torch",
                           run=lambda *a: None)
    with pytest.raises(exec_plan.PlanError):
        exec_plan.route("matmul", "no_such_route")


def test_fused_route_needs_prepared_weights():
    from repro_torch.core.linear import apply_linear
    x = torch.zeros((2, 64))
    with pytest.raises(ValueError, match="prepare"):
        apply_linear({"w": torch.zeros((64, 32))}, x, "w4a8_kv4_attn8")
    with pytest.raises(TypeError):
        apply_linear({"w": torch.zeros((64, 32), dtype=torch.uint8)}, x,
                     "fp32")
