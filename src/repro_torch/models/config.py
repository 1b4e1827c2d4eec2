"""Architecture configuration shared by the model zoo and launch layer
(a verbatim copy of `repro.models.config`, which the port may not
import)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # decoder | encdec | rglru | xlstm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "silu"            # silu (SwiGLU) | gelu (plain MLP)
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # hybrid (RecurrentGemma): repeating block pattern
    pattern: Tuple[str, ...] = ()    # e.g. ("rg", "rg", "attn")
    window: int = 0                  # local-attention window
    d_rnn: int = 0                   # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    # xLSTM
    slstm_every: int = 0             # one sLSTM per this many layers
    chunk: int = 64                  # mLSTM chunkwise-parallel chunk length
    # enc-dec (whisper): n_layers applies to BOTH stacks
    n_enc_layers: int = 0
    # modality frontend: "none" (token ids) | "stub" (precomputed embeddings)
    frontend: str = "none"
    max_seq: int = 1 << 20
    # execution
    dtype: str = "float32"           # compute dtype (bf16 on TPU)
    policy: str = "fp32"             # TransPrecisionPolicy preset name
    remat: str = "none"              # none | dots | full
    attn_chunk: int = 0              # q-block-chunked attention (0 = off)
    use_flash: bool = False          # Pallas attention kernel (prefill)
    logits_chunk: int = 0            # beyond-paper: chunked loss (0 = off)
    # --- perf-iteration knobs (EXPERIMENTS.md §Perf) ---
    mesh_plan: str = "tp"            # "tp" (TP+SP on model) | "fully_dp"
    params_dtype: str = "fp32"       # train-state param storage dtype
    serve_param_mode: str = "fsdp"   # "fsdp" | "tp_only" (serve replication)
    serve_quant: str = ""            # "" | "fp8_e4m3" weight-only storage
    flash_decode: bool = False       # shard_map partial-softmax decode
                                     # (raw caches only: with a
                                     # kv-quantized policy, decode takes
                                     # the DPA quantized-cache path and
                                     # this flag is ignored)
    remat_block: int = 0             # two-level remat: outer scan saves x
                                     # every `remat_block` groups (sqrt-L
                                     # activation memory)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def _mixer_params(self, kind: str) -> int:
        d, hd, H, KV = self.d_model, self.hd, self.n_heads, self.n_kv_heads
        if kind in ("attn", "attn_local", "enc", "dec"):
            return d * hd * (H + 2 * KV) + H * hd * d
        if kind == "rg":
            dr = self.d_rnn or d
            return 3 * d * dr + dr * d + self.conv_width * dr
        if kind == "mlstm":
            return 5 * d * H * hd + 2 * d * H
        if kind == "slstm":
            return 5 * d * d + 4 * d
        raise ValueError(kind)

    def _pattern(self):
        if self.family == "rglru":
            return tuple(self.pattern) or ("rg", "rg", "attn_local")
        if self.family == "xlstm":
            n = self.slstm_every or 8
            return ("mlstm",) * (n - 1) + ("slstm",)
        return ("attn",)

    @property
    def n_params(self) -> int:
        """Parameter count (pattern-aware; embeddings included once)."""
        d, L = self.d_model, self.n_layers
        if self.act == "silu":
            mlp_dense = 3 * d * self.d_ff
        else:
            mlp_dense = 2 * d * self.d_ff
        if self.is_moe:
            mlp = self.n_experts * mlp_dense + d * self.n_experts
        else:
            mlp = mlp_dense
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            attn = self._mixer_params("attn")
            per_layer = attn + mlp + 2 * d
            return ((self.n_enc_layers or L) * per_layer
                    + L * (per_layer + attn + d) + emb + self.max_seq * d)
        pat = self._pattern()
        total = emb
        for i in range(L):
            total += self._mixer_params(pat[i % len(pat)]) + mlp + 2 * d
        return total

    @property
    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params
        d, L = self.d_model, self.n_layers
        mlp_dense = (3 if self.act == "silu" else 2) * d * self.d_ff
        inactive = L * (self.n_experts - self.top_k) * mlp_dense
        return self.n_params - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
