"""StableLM-2-1.6B — 24L, d_model=2048, 32H (MHA kv=32), d_ff=5632,
vocab=100352. LayerNorm + partial rotary (25%).
[hf:stabilityai/stablelm-2-1_6b]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=5632,
    vocab_size=100352,
    max_seq_len=4096,
    norm="layernorm",
    norm_eps=1e-5,
    pos_emb="rope_partial",
    rotary_pct=0.25,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
