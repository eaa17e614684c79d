"""Yi-34B — 60L, d_model=7168, 56H (GQA kv=8), d_ff=20480, vocab=64000.
Llama-family GQA.  [arXiv:2403.04652]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    source="arXiv:2403.04652",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    max_seq_len=4096,
    rope_theta=5_000_000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
