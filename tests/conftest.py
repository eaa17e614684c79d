"""Shared fixtures: tiny model configs for fast CPU tests.

Device count stays at 1 here (the 512-device forcing happens ONLY inside
repro.launch.dryrun, per the brief).
"""

from __future__ import annotations

import os

import jax
import pytest

from repro.models.config import MLAConfig, ModelConfig, MoEConfig

jax.config.update("jax_enable_x64", False)

# -- pre-existing seed failures -------------------------------------------
# tests/seed_xfails.txt is the single source of truth for the known-bad
# node ids ("no worse than seed" bar): they run as xfail(strict=False), so
# plain `pytest -x -q` agrees between local runs and CI with no deselect
# flags — and an accidental fix shows up as XPASS instead of breaking.

_XFAIL_FILE = os.path.join(os.path.dirname(__file__), "seed_xfails.txt")


def _seed_xfail_prefixes():
    try:
        with open(_XFAIL_FILE) as f:
            lines = (ln.strip() for ln in f)
            return [ln for ln in lines if ln and not ln.startswith("#")]
    except OSError:
        return []


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the PyTorch port's hand-written "
        "kernels); skips where there is none")


def pytest_collection_modifyitems(config, items):
    prefixes = _seed_xfail_prefixes()
    if not prefixes:
        return
    marker = pytest.mark.xfail(
        reason="pre-existing seed failure (tests/seed_xfails.txt)",
        strict=False)
    for item in items:
        nodeid = item.nodeid.replace(os.sep, "/")
        for p in prefixes:
            # a bare prefix matches the whole function incl. parametrized
            # variants (::name[...]), but not a longer name sharing it
            if nodeid == p or nodeid.startswith(p + "["):
                item.add_marker(marker)
                break


def tiny_dense(**kw) -> ModelConfig:
    base = dict(name="tiny-dense", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                max_seq_len=256)
    base.update(kw)
    return ModelConfig(**base).validate()


def tiny_moe(**kw) -> ModelConfig:
    base = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                max_seq_len=256,
                moe=MoEConfig(n_experts=4, top_k=2, expert_d_ff=64))
    base.update(kw)
    return ModelConfig(**base).validate()


def tiny_mla(**kw) -> ModelConfig:
    base = dict(name="tiny-mla", family="moe", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                max_seq_len=256,
                mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_rope_dim=8,
                              qk_nope_dim=16, v_head_dim=16))
    base.update(kw)
    return ModelConfig(**base).validate()


def tiny_hybrid(**kw) -> ModelConfig:
    base = dict(name="tiny-hybrid", family="hybrid", n_layers=3, d_model=64,
                n_heads=4, n_kv_heads=1, d_ff=128, vocab_size=256,
                max_seq_len=256, mixer_pattern=("rglru", "rglru", "local_gqa"),
                local_window=32, lru_width=64)
    base.update(kw)
    return ModelConfig(**base).validate()


def tiny_xlstm(**kw) -> ModelConfig:
    base = dict(name="tiny-xlstm", family="ssm", n_layers=2, d_model=64,
                n_heads=2, n_kv_heads=2, d_ff=0, vocab_size=256,
                max_seq_len=256, mixer_pattern=("mlstm", "slstm"))
    base.update(kw)
    return ModelConfig(**base).validate()


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)
