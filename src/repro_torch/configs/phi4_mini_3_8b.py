"""Phi-4-mini 3.8B — 32L, d_model=3072, 24H (GQA kv=8), d_ff=8192,
vocab=200064. RoPE + SwiGLU + GQA.  [arXiv:2412.08905]

``--variant sliding`` (serve launcher) adds a 4096-token sliding window so
one dense arch exercises the sub-quadratic long_500k path (see DESIGN.md
§Shape skips)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    source="arXiv:2412.08905",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    max_seq_len=4096,
    tie_embeddings=True,
    rope_theta=10000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
