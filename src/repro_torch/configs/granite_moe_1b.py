"""Granite-3.0-1B-A400M [hf:ibm-granite]: 32 experts top-8 MoE."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab_size=49155,
    n_experts=32, top_k=8, tie_embeddings=True,
    rope_theta=1e4,
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
