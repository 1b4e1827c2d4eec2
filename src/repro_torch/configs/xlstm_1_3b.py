"""xLSTM-1.3B [arXiv:2405.04517]: mLSTM + sLSTM blocks (1 sLSTM per 8),
d_ff=0 (mixer-only blocks), 4 heads."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="xlstm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
    d_ff=0, vocab_size=50304,
    slstm_every=8, chunk=64,
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
