"""DeepSeek-V2 236B — 60L, d_model=5120, 128H, vocab=102400. MLA with
kv_lora_rank=512 (+64 rope dims), q_lora_rank=1536; MoE: 2 shared + 160
routed experts top-6, expert d_ff=1536; first block dense (d_ff=12288).
[arXiv:2405.04434]"""

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,               # informational; MLA replaces GQA caching
    head_dim=128,
    d_ff=12288,                   # the dense first block
    vocab_size=102400,
    max_seq_len=32768,
    rope_theta=10000.0,
    moe=MoEConfig(n_experts=160, top_k=6, expert_d_ff=1536,
                  n_shared_experts=2, shared_d_ff=1536,
                  capacity_factor=1.25),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=128),
    dense_block_ids=(0,),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
