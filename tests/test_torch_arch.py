"""The four dense GQA configs of the port (minicpm-2b, stablelm-1.6b,
yi-34b, phi4-mini-3.8b), the two large MoE configs (deepseek-v2-236b:
MLA, shared experts, a dense first block; qwen3-moe-235b-a22b: g 16) and
the two recurrent configs (recurrentgemma-9b, xlstm-1.3b) against the JAX package on the CPU, in fp32: the smoke variants' forwards
with a cache and one decode step, on the same weights (the JAX init converted through ``repro_torch.convert``);
layered and chunked engine traces per family feature (stablelm's
layernorm and partial RoPE, phi4-mini's tied embeddings and group size);
and the launcher serving phi4-mini with speculation.  Tolerance as in
tests/test_torch_model.py: rtol 1e-5 and atol 1e-5 of the tensor's
scale."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_parity as parity
from repro.configs import get_smoke_config as jax_get_smoke_config
from test_torch_model import close, jit, models, t

DENSE_ARCHS = ["minicpm-2b", "stablelm-1.6b", "yi-34b", "phi4-mini-3.8b"]
MOE_ARCHS = ["deepseek-v2-236b", "qwen3-moe-235b-a22b"]
RECURRENT_ARCHS = ["recurrentgemma-9b", "xlstm-1.3b"]


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + RECURRENT_ARCHS)
def test_smoke_forward_matches_jax(arch):
    """A 16-token prefill into the cache at per-row offsets, then one
    decode step: logits and every cache leaf (GQA's ``k``/``v``, MLA's
    ``ckv``/``kr``, the recurrent mixers' state); then the no-cache
    forward."""
    cfg = jax_get_smoke_config(arch)
    jm, jp, tm, tp = models(cfg)
    rng = np.random.default_rng(21)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 17)).astype(np.int32)
    off = np.asarray([0, 6], np.int32)
    jc, tc = jm.init_cache(2, 40), tm.init_cache(2, 40)
    fwd = jit(jm.forward, dropless=True, moe_dispatch="ragged")
    for sl, o in ((slice(0, 16), off), (slice(16, 17), off + 16)):
        lj, jc, _ = fwd(jp, toks[:, sl], offset=o, cache=jc)
        lt, tc, _ = tm.forward(tp, t(toks[:, sl]).long(), offset=t(o),
                               cache=tc)
        close(lt, lj)
    for seg_t, seg_j in zip(tc, jc):
        for ct, cj in zip(seg_t, seg_j):
            assert sorted(ct) == sorted(cj)
            for leaf in ct:
                close(ct[leaf], cj[leaf])
    lj, _, _ = fwd(jp, toks)
    lt, _, _ = tm.forward(tp, t(toks).long())
    close(lt, lj)


def _jobs():
    rng = np.random.default_rng(5)
    return [(rng.integers(1, 500, int(rng.integers(4, 20))).tolist(), 6)
            for _ in range(5)]


@pytest.mark.parametrize("sched", ["layered", "chunked"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi4-mini-3.8b"])
def test_smoke_engine_trace_matches_jax(arch, sched):
    """Closed-loop jobs in a pool small enough to preempt: identical
    plans, token streams, TTFTs and preemptions."""
    cfg = jax_get_smoke_config(arch)
    kw = dict(max_len=64, pages=12, page_size=4, decode_reserve=1)
    want = parity.run("jax", cfg, sched, jobs=_jobs(), **kw)
    got = parity.run("torch", cfg, sched, jobs=_jobs(), **kw)
    parity.assert_same(got, want)
    assert got["n_preempted"] > 0
    assert all(len(toks) == 6 for toks in got["outputs"].values())


def test_launcher_serves_phi4_mini_with_ngram_speculation(capsys):
    """``--arch phi4-mini-3.8b --smoke --device cpu --spec ngram``."""
    from repro_torch.launch import serve
    serve.main(["--arch", "phi4-mini-3.8b", "--smoke", "--device", "cpu",
                "--spec", "ngram", "--requests", "3", "--slots", "4",
                "--max-len", "64"])
    out = capsys.readouterr().out
    assert "phi4-mini-3.8b-smoke x layered" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] spec(ngram, k=4)"))
    assert " 0 verify" not in line, line
