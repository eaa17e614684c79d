"""MiniCPM-2B — 40L, d_model=2304, 36H (MHA kv=36), d_ff=5760, vocab=122753.
Llama-like arch; trained with the WSD schedule (exercised by the training
substrate).  [arXiv:2404.06395]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    source="arXiv:2404.06395",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    max_seq_len=4096,
    tie_embeddings=True,
    rope_theta=10000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
