"""Qwen3-30B-A3B — the paper's primary evaluation model ("Qwen"). 48L,
d_model=2048, 32H (GQA kv=4, head_dim=128), 128 experts top-8, expert
d_ff=768, vocab=151936.  [hf:Qwen/Qwen3-30B-A3B; paper Table 3]"""

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-30b-a3b",
    family="moe",
    source="hf:Qwen/Qwen3-30B-A3B; paper Table 3",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, expert_d_ff=768,
                  capacity_factor=1.25),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
