"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409]: pixtral-ViT frontend
(STUB: input_specs supplies precomputed patch embeddings) + mistral-nemo
backbone."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1e6, frontend="stub",
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
