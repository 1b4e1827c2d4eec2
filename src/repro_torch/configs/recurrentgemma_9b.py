"""RecurrentGemma-9B [arXiv:2402.19427]: RG-LRU + local attention, 1:2
(pattern rg,rg,attn_local), MQA kv=1, window 2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="rglru",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    pattern=("rg", "rg", "attn_local"), window=2048, d_rnn=4096,
    rope_theta=1e4,
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
