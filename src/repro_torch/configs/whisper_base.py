"""Whisper-base — enc-dec, 6L encoder + 6L decoder, d_model=512, 8H,
d_ff=2048, vocab=51865. Conv/mel frontend STUBBED per the brief: the encoder
consumes precomputed frame embeddings (B, 1500, 512).  [arXiv:2212.04356]

Note: real whisper caps the decoder at 448 positions; the learned-position
table here is sized by max_seq_len so the framework's decode_32k shape can
exercise the enc-dec path (recorded as a deviation in DESIGN.md)."""

from repro_torch.models.config import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    source="arXiv:2212.04356",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    max_seq_len=32768,
    norm="layernorm",
    norm_eps=1e-5,
    activation="gelu",
    pos_emb="learned",
    tie_embeddings=True,
    encoder=EncoderConfig(n_layers=6, n_frames=1500),
    dtype="bfloat16",
    param_dtype="bfloat16",
)
