"""Qwen3-MoE 235B-A22B — 94L, d_model=4096, 64H (GQA kv=4), expert d_ff=1536,
vocab=151936, 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B family / Qwen3
Technical Report arXiv:2505.09388]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; arXiv:2505.09388",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=12288,                      # unused: every block is MoE
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=1536,
                  capacity_factor=1.25),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
