"""Model configuration covering all assigned architecture families.

One dataclass describes every architecture in the pool: dense llama-family
(GQA/MHA), MoE (Qwen3-MoE style and DeepSeek-V2 MLA+shared-expert style),
hybrid recurrent (RecurrentGemma RG-LRU + local attention), xLSTM
(sLSTM/mLSTM), VLM language backbones (M-RoPE) and enc-dec audio backbones
(whisper).  The block stack is an explicit sequence of ``BlockSpec``s so the
scheduler (core/) and the model runtime (models/model.py) share a single
source of truth for what "layer i" means.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Block-level specification
# ---------------------------------------------------------------------------

# Temporal-mixing choices.
MIXER_GQA = "gqa"            # (grouped-query / multi-head) full attention
MIXER_LOCAL = "local_gqa"    # sliding-window local attention
MIXER_MLA = "mla"            # DeepSeek-V2 multi-head latent attention
MIXER_RGLRU = "rglru"        # RecurrentGemma real-gated LRU block
MIXER_MLSTM = "mlstm"        # xLSTM matrix-memory LSTM
MIXER_SLSTM = "slstm"        # xLSTM scalar-memory LSTM

# FFN choices.
FFN_DENSE = "dense"
FFN_MOE = "moe"
FFN_NONE = "none"            # xLSTM blocks integrate their own projections


# Bytes per element by dtype name — the single source of truth for weight
# traffic accounting (engine counter, cost model). Substring heuristics like
# `2 if "16" in dtype else 4` misreport fp8/int8 as 4 B/elem.
DTYPE_BYTES = {
    "float64": 8, "int64": 8,
    "float32": 4, "int32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2,
    "float8_e4m3fn": 1, "float8_e5m2": 1, "float8_e4m3": 1,
    "fp8": 1, "int8": 1, "uint8": 1, "int4": 1,
}


def dtype_bytes(name: str) -> int:
    """Bytes/element for a dtype name; falls back on bit-width parsing for
    names not in DTYPE_BYTES (e.g. jnp dtype str spellings)."""
    if name in DTYPE_BYTES:
        return DTYPE_BYTES[name]
    for bits, nbytes in (("64", 8), ("32", 4), ("16", 2), ("8", 1), ("4", 1)):
        if bits in name:
            return nbytes
    return 4


@dataclass(frozen=True)
class BlockSpec:
    """What one decoder block is made of."""

    mixer: str = MIXER_GQA
    ffn: str = FFN_DENSE
    cross_attn: bool = False          # whisper decoder blocks
    window: Optional[int] = None      # sliding/local attention window

    def is_attention(self) -> bool:
        return self.mixer in (MIXER_GQA, MIXER_LOCAL, MIXER_MLA)

    def is_recurrent(self) -> bool:
        return self.mixer in (MIXER_RGLRU, MIXER_MLSTM, MIXER_SLSTM)


# ---------------------------------------------------------------------------
# Model-level configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0              # per-expert hidden size
    n_shared_experts: int = 0         # DeepSeek-V2 shared experts
    shared_d_ff: int = 0              # hidden size of the shared expert(s)
    capacity_factor: float = 1.25     # GShard-style dispatch capacity
    router_aux_coef: float = 0.001    # load-balance aux loss (training)

    @property
    def enabled(self) -> bool:
        return self.n_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 0
    q_lora_rank: int = 0              # 0 => no query compression
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec models (whisper). The modality frontend
    (mel-spectrogram + conv subsampling) is stubbed per the brief: inputs
    arrive as precomputed frame embeddings of shape (B, n_frames, d_model)."""

    n_layers: int = 0
    n_frames: int = 1500              # whisper: 30 s audio -> 1500 frames

    @property
    def enabled(self) -> bool:
        return self.n_layers > 0


@dataclass(frozen=True)
class VisionStubConfig:
    """VLM frontends are stubbed: ``input_specs`` provides patch embeddings
    already projected to d_model. M-RoPE still runs in the backbone with
    (temporal, height, width) position ids."""

    n_patches: int = 0                # extra multimodal tokens prepended

    @property
    def enabled(self) -> bool:
        return self.n_patches > 0


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"             # dense | moe | hybrid | ssm | vlm | audio
    source: str = ""                  # citation: paper / model card

    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0                 # 0 => d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 4096

    norm: str = "rmsnorm"             # rmsnorm | layernorm
    norm_eps: float = 1e-6
    activation: str = "swiglu"        # swiglu | gelu | geglu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # Positional encoding: "rope" | "rope_partial" | "mrope" | "learned" | "none"
    pos_emb: str = "rope"
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0           # stablelm uses 0.25
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl (t, h, w) split of rope dims

    # Sub-structures
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    vision: VisionStubConfig = field(default_factory=VisionStubConfig)

    # Hybrid / recurrent structure ------------------------------------------------
    # Pattern of mixers tiled over the depth, e.g. ("rglru","rglru","gqa").
    # Empty tuple => homogeneous attention stack.
    mixer_pattern: Tuple[str, ...] = ()
    # MoE only on some blocks (DeepSeek-V2 uses a dense first block).
    dense_block_ids: Tuple[int, ...] = ()
    local_window: int = 2048          # window for MIXER_LOCAL blocks
    sliding_window: Optional[int] = None  # window applied to ALL gqa blocks
    lru_width: int = 0                # RG-LRU recurrence width (0 => d_model)
    conv_width: int = 4               # RG-LRU temporal-conv width

    # Numerics
    dtype: str = "float32"            # activation dtype
    param_dtype: str = "float32"

    # -- derived -----------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def block_specs(self) -> Tuple[BlockSpec, ...]:
        """The explicit per-block structure for the whole decoder stack."""
        specs = []
        for i in range(self.n_layers):
            if self.mixer_pattern:
                mixer = self.mixer_pattern[i % len(self.mixer_pattern)]
            elif self.mla.enabled:
                mixer = MIXER_MLA
            else:
                mixer = MIXER_GQA
            window = None
            if mixer == MIXER_LOCAL:
                window = self.local_window
            elif mixer == MIXER_GQA and self.sliding_window:
                window = self.sliding_window
            if mixer in (MIXER_MLSTM, MIXER_SLSTM):
                ffn = FFN_NONE if self.d_ff == 0 else FFN_DENSE
            elif self.moe.enabled and i not in self.dense_block_ids:
                ffn = FFN_MOE
            else:
                ffn = FFN_DENSE
            specs.append(
                BlockSpec(mixer=mixer, ffn=ffn,
                          cross_attn=self.encoder.enabled, window=window)
            )
        return tuple(specs)

    def scan_segments(self) -> Tuple[Tuple[Tuple[BlockSpec, ...], int], ...]:
        """Group the block stack into (pattern, repeats) segments so the full
        forward pass can lax.scan over stacked parameters instead of unrolling
        n_layers HLO copies. A homogeneous stack yields one segment with a
        1-block pattern; RecurrentGemma yields ((r,r,a), 12) + ((r,), 2)."""
        specs = self.block_specs()
        if not specs:
            return ()
        # Find the smallest period p such that specs is (pattern * k) + prefix
        # of pattern. Try small periods first.
        n = len(specs)
        for p in range(1, min(n, 16) + 1):
            if all(specs[i] == specs[i % p] for i in range(n)):
                reps, rem = divmod(n, p)
                segs = [(tuple(specs[:p]), reps)]
                if rem:
                    segs.append((tuple(specs[:rem]), 1))
                return tuple(segs)
        # Fallback: irregular stack — single segment per contiguous run.
        segs = []
        run_start = 0
        for i in range(1, n + 1):
            if i == n or specs[i] != specs[run_start]:
                segs.append(((specs[run_start],), i - run_start))
                run_start = i
        return tuple(segs)

    def block_index_map(self) -> Tuple[Tuple[int, int, int], ...]:
        """block id -> (segment, repeat, position-in-pattern)."""
        out = []
        b = 0
        for s, (pattern, reps) in enumerate(self.scan_segments()):
            for r in range(reps):
                for p in range(len(pattern)):
                    out.append((s, r, p))
                    b += 1
        return tuple(out)

    # -- sizes (used by the cost model and roofline) -------------------------------

    def attn_param_count(self, spec: BlockSpec) -> int:
        d, hd = self.d_model, self.head_dim_
        if spec.mixer == MIXER_MLA:
            m = self.mla
            qdim = self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
            n = 0
            if m.q_lora_rank:
                n += d * m.q_lora_rank + m.q_lora_rank * qdim
            else:
                n += d * qdim
            n += d * (m.kv_lora_rank + m.qk_rope_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
            return n
        if spec.mixer in (MIXER_GQA, MIXER_LOCAL):
            return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if spec.mixer == MIXER_RGLRU:
            w = self.lru_width or d
            nb = 16  # block-diagonal gates (Griffin block_width)
            return 2 * d * w + w * d + self.conv_width * w + 2 * nb * (w // nb) ** 2
        if spec.mixer in (MIXER_MLSTM, MIXER_SLSTM):
            # qkv + gates + output over the (2x) inner dim
            inner = 2 * d
            return d * inner * 2 + inner * d + 3 * inner * (inner // max(self.n_heads, 1))
        raise ValueError(spec.mixer)

    def ffn_param_count(self, spec: BlockSpec) -> int:
        d = self.d_model
        if spec.ffn == FFN_NONE:
            return 0
        if spec.ffn == FFN_MOE:
            e = self.moe
            per_expert = 3 * d * e.expert_d_ff
            shared = e.n_shared_experts * 3 * d * e.shared_d_ff
            router = d * e.n_experts
            return e.n_experts * per_expert + shared + router
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def expert_bytes(self, bytes_per_param: int = 2) -> int:
        """Bytes of ONE routed expert's weights (the unit of the paper's
        expert-load counter)."""
        return 3 * self.d_model * self.moe.expert_d_ff * bytes_per_param

    def param_count(self) -> int:
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self.block_specs():
            n += self.attn_param_count(spec) + self.ffn_param_count(spec)
            n += 2 * self.d_model  # norms
        if self.encoder.enabled:
            enc_spec = BlockSpec(mixer=MIXER_GQA, ffn=FFN_DENSE)
            n += self.encoder.n_layers * (
                self.attn_param_count(enc_spec) + self.ffn_param_count(enc_spec)
            )
        return n

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        n = self.vocab_size * self.d_model * (1 if self.tie_embeddings else 2)
        for spec in self.block_specs():
            n += self.attn_param_count(spec) + 2 * self.d_model
            if spec.ffn == FFN_MOE:
                e = self.moe
                n += e.top_k * 3 * self.d_model * e.expert_d_ff
                n += e.n_shared_experts * 3 * self.d_model * e.shared_d_ff
                n += self.d_model * e.n_experts
            else:
                n += self.ffn_param_count(spec)
        return n

    def kv_bytes_per_token(self, bytes_per_el: int = 2) -> int:
        """KV-cache bytes per token across all blocks (0 for pure recurrent)."""
        total = 0
        for spec in self.block_specs():
            if spec.mixer == MIXER_MLA:
                total += (self.mla.kv_lora_rank + self.mla.qk_rope_dim) * bytes_per_el
            elif spec.is_attention():
                total += 2 * self.n_kv_heads * self.head_dim_ * bytes_per_el
        return total

    def stash_token_factor(self) -> float:
        """KV-token-equivalents charged per layered-prefill boundary-
        activation token (one d_model vector) — PagedKVAllocator's
        ``stash_factor``. Element size cancels, so this is dtype-free;
        pure-recurrent stacks (no KV growth) fall back to 1.0."""
        kv_els = self.kv_bytes_per_token(1)
        return self.d_model / kv_els if kv_els > 0 else 1.0

    def validate(self) -> "ModelConfig":
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, self.name
        if self.moe.enabled:
            assert self.moe.top_k <= self.moe.n_experts
        if self.mixer_pattern:
            for m in self.mixer_pattern:
                assert m in (MIXER_GQA, MIXER_LOCAL, MIXER_MLA, MIXER_RGLRU,
                             MIXER_MLSTM, MIXER_SLSTM), m
        return self


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_experts: int = 4, vocab: int = 512, seq: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (per the brief: <=2
    layers, d_model<=512, <=4 experts). Preserves structural features
    (GQA ratio, MoE-ness, MLA, mixer pattern, enc-dec)."""
    d_model = min(d_model, 512)
    n_heads = max(4, min(cfg.n_heads, 8))
    # preserve grouping ratio approximately
    ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
    n_kv = max(1, n_heads // min(ratio, n_heads))
    head_dim = d_model // n_heads
    moe = cfg.moe
    if moe.enabled:
        k = min(moe.top_k, 2)
        moe = dataclasses.replace(
            moe, n_experts=min(moe.n_experts, n_experts), top_k=k,
            expert_d_ff=d_model, shared_d_ff=d_model if moe.n_shared_experts else 0,
            n_shared_experts=min(moe.n_shared_experts, 1))
    mla = cfg.mla
    if mla.enabled:
        mla = dataclasses.replace(mla, kv_lora_rank=64,
                                  q_lora_rank=64 if mla.q_lora_rank else 0,
                                  qk_rope_dim=16, qk_nope_dim=head_dim,
                                  v_head_dim=head_dim)
    enc = cfg.encoder
    if enc.enabled:
        enc = dataclasses.replace(enc, n_layers=min(enc.n_layers, 2), n_frames=64)
    pattern = cfg.mixer_pattern
    if pattern:
        n_layers = max(n_layers, len(pattern))  # keep one full period
    mrope = cfg.mrope_sections
    if mrope:
        # rescale sections to the reduced rotary dim (head_dim // 2 pairs)
        half = head_dim // 2
        base = half // len(mrope)
        mrope = tuple([half - base * (len(mrope) - 1)] + [base] * (len(mrope) - 1))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers, d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=head_dim, d_ff=2 * d_model, vocab_size=vocab,
        max_seq_len=seq, moe=moe, mla=mla, encoder=enc,
        lru_width=d_model if cfg.lru_width else 0,
        local_window=min(cfg.local_window, 128),
        sliding_window=min(cfg.sliding_window, 128) if cfg.sliding_window else None,
        mrope_sections=mrope,
        dense_block_ids=tuple(i for i in cfg.dense_block_ids if i < n_layers),
        dtype="float32", param_dtype="float32",
    ).validate()
