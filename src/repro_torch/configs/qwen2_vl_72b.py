"""Qwen2-VL-72B language backbone — 80L, d_model=8192, 64H (GQA kv=8),
d_ff=29568, vocab=152064, M-RoPE (sections t/h/w = 16/24/24 over the 64
rotary pairs), dynamic-resolution ViT frontend STUBBED per the brief
(``input_specs`` provides patch embeddings).  [arXiv:2409.12191]"""

from repro_torch.models.config import ModelConfig, VisionStubConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    max_seq_len=32768,
    pos_emb="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    vision=VisionStubConfig(n_patches=256),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
