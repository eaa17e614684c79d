"""RecurrentGemma-9B (Griffin) — 38 blocks, d_model=4096, 16H (MQA kv=1),
d_ff=12288, vocab=256000. Pattern: 2 RG-LRU recurrent blocks : 1 local
(window 2048) attention block. Sub-quadratic -> runs the long_500k shape.
[arXiv:2402.19427]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    max_seq_len=8192,            # local attention window bounds KV memory
    activation="geglu",
    mixer_pattern=("rglru", "rglru", "local_gqa"),
    local_window=2048,
    lru_width=4096,
    conv_width=4,
    logit_softcap=30.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
)
