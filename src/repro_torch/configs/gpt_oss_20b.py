"""GPT-OSS-20B — the paper's second evaluation model ("GPT"). 24L,
d_model=2880, 64H (GQA kv=8, head_dim=64), 32 experts top-4, vocab=201088.
[arXiv:2508.10925; paper Table 3]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="gpt-oss-20b",
    family="moe",
    source="arXiv:2508.10925; paper Table 3",
    n_layers=24,
    d_model=2880,
    n_heads=64,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2880,
    vocab_size=201088,
    max_seq_len=32768,
    rope_theta=150_000.0,
    moe=MoEConfig(n_experts=32, top_k=4, expert_d_ff=2880,
                  capacity_factor=1.25),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
