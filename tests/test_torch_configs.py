"""The port's registered configurations against the JAX package's: the
paper's two models, the four dense GQA decoders, the two large MoE
models (deepseek-v2-236b, qwen3-moe-235b-a22b) and the two recurrent
models (recurrentgemma-9b, xlstm-1.3b), whisper-base and qwen2-vl-72b
(all twelve of the JAX registry) field for field (full and smoke
variants), and the smoke gpt-oss-20b engine trace through both
packages (identical plans, tokens, TTFTs and expert bytes, layered and
chunked).  The dense configs' forwards and engine traces are held against
JAX in tests/test_torch_arch.py."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import _torch_parity as parity
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_configs as jax_list_configs
from repro_torch.configs import get_config, get_smoke_config, list_configs

ARCHS = ["qwen3-30b-a3b", "gpt-oss-20b"]
DENSE_ARCHS = ["minicpm-2b", "stablelm-1.6b", "yi-34b", "phi4-mini-3.8b"]
MOE_ARCHS = ["deepseek-v2-236b", "qwen3-moe-235b-a22b"]
RECURRENT_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b"]
MULTIMODAL_ARCHS = ["whisper-base", "qwen2-vl-72b"]


def test_port_registers_the_papers_two_models():
    """The paper's two models first, then the dense GQA decoders, the
    large MoE models, the recurrent models, whisper and qwen2-vl: the
    whole JAX registry."""
    assert list_configs() == (ARCHS + DENSE_ARCHS + MOE_ARCHS
                              + RECURRENT_ARCHS + MULTIMODAL_ARCHS)
    assert sorted(list_configs()) == sorted(jax_list_configs())


@pytest.mark.parametrize("arch", ARCHS + DENSE_ARCHS + MOE_ARCHS
                         + RECURRENT_ARCHS + MULTIMODAL_ARCHS)
def test_config_matches_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_get_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(jax_get_smoke_config(arch))


def test_gpt_oss_20b_widths():
    cfg = get_config("gpt-oss-20b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim_) == (24, 2880, 64, 8, 64)
    assert (cfg.moe.n_experts, cfg.moe.top_k, cfg.moe.expert_d_ff) == \
        (32, 4, 2880)
    assert (cfg.vocab_size, cfg.rope_theta) == (201088, 150000.0)
    # one expert's SwiGLU weights in bf16: 3 x 2880 x 2880 x 2 B
    assert cfg.expert_bytes(2) == 3 * 2880 * 2880 * 2


def _jobs():
    rng = np.random.default_rng(3)
    return [(rng.integers(1, 500, int(rng.integers(4, 20))).tolist(), 6)
            for _ in range(5)]


# each scheduler's pool is small enough to preempt once on this trace
@pytest.mark.parametrize("sched,pages", [("layered", 16), ("chunked", 14)])
def test_smoke_gpt_oss_engine_trace_matches_jax(sched, pages):
    """The smoke gpt-oss-20b (2 layers, 8/1 heads, hd 32, 4 experts top-2)
    in a pool small enough to preempt."""
    cfg = jax_get_smoke_config("gpt-oss-20b")
    kw = dict(max_len=64, pages=pages, page_size=4, decode_reserve=1)
    want = parity.run("jax", cfg, sched, jobs=_jobs(), **kw)
    got = parity.run("torch", cfg, sched, jobs=_jobs(), **kw)
    parity.assert_same(got, want)
    assert got["n_preempted"] > 0
    assert all(len(t) == 6 for t in got["outputs"].values())


def test_large_moe_widths():
    """deepseek-v2-236b: MLA (kv_lora 512 + 64 rope dims: 1152 B a token
    and layer in bf16), 2 shared + 160 routed experts top-6, a dense first
    block (two segments); qwen3-moe-235b-a22b: 64/4 heads (g 16)."""
    ds = get_config("deepseek-v2-236b")
    assert (ds.n_layers, ds.d_model, ds.n_heads) == (60, 5120, 128)
    assert ds.kv_bytes_per_token(2) == 60 * 1152
    assert [reps for _, reps in ds.scan_segments()] == [1, 59]
    assert ds.expert_bytes(2) == 3 * 5120 * 1536 * 2
    qw = get_config("qwen3-moe-235b-a22b")
    assert (qw.n_heads // qw.n_kv_heads, qw.head_dim_) == (16, 128)
    assert qw.expert_bytes(2) == 3 * 4096 * 1536 * 2
