"""Whisper-medium [arXiv:2212.04356]: enc-dec, conv frontend STUB
(input_specs supplies precomputed frame embeddings).  24 encoder + 24
decoder layers, LayerNorm/GELU, learned positions (no RoPE)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    head_dim=64, d_ff=4096, vocab_size=51865,
    act="gelu", norm="layernorm", rope_theta=0.0,
    frontend="stub", max_seq=32768 + 64,
    dtype="bf16", policy="fp8_dpa", remat="full", attn_chunk=512, logits_chunk=512,
)
N_AUDIO_CTX = 1500  # encoder frames after the (stubbed) conv frontend
