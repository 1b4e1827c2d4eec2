"""DBRX-132B [hf:databricks/dbrx-base]: 16 experts top-4, fine-grained."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4,
    rope_theta=5e5,
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
