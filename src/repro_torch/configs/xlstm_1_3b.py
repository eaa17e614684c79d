"""xLSTM-1.3B — 48 blocks, d_model=2048, 4 heads, vocab=50304. d_ff=0:
projections are integrated in the m/sLSTM blocks. Paper's 7:1 mLSTM:sLSTM
interleave. Pure recurrent state -> runs the long_500k shape.
[arXiv:2405.04517]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=8192,
    norm="layernorm",
    norm_eps=1e-5,
    mixer_pattern=("mlstm",) * 7 + ("slstm",),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
