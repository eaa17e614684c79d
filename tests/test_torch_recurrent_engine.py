"""The port's engine on recurrent stacks (``tiny_hybrid``: RG-LRU, RG-LRU,
local attention; ``tiny_xlstm``: mLSTM, sLSTM) against the JAX package on
the CPU, in fp32.

* Where the JAX engine is right — as many slots as requests, no
  preemption, no prefix hit, speculation off — the port gives its plans,
  token streams and TTFTs under all five schedulers (the cross-package
  form of tests/test_engine_equivalence.py's hybrid and xlstm cases).
* Where it is not — a slot that another request used: more requests than
  slots, recompute preemption, swap preemption, two pools (the JAX engine
  never resets a slot's recurrent state at admission, and moves a
  recurrent leaf's first positions, not its state) — every port stream
  equals the JAX package's cache-free greedy forward for that prompt
  (tests/test_engine_equivalence.py's ``reference_generate`` loop, its
  forward jitted once at a padded length: the model is causal, so tokens
  after the sequence change no logit of it), and the port's plans equal
  the JAX engine's (plans do not depend on tokens without EOS).
* A recurrent stack refuses the prefix cache and speculation, in the
  engine and in ``ServeConfig.validate``; the launcher serves it with the
  prefix cache off.

Tokens, plans and TTFTs compare exactly."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parity as parity
from conftest import tiny_hybrid, tiny_xlstm
from repro_torch.launch import serve
from repro_torch.launch.config import ServeConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.traffic import TraceRequest
from test_engine_equivalence import PROMPTS, SCHEDS
from test_torch_model import models

OFF = dict(prefix_cache=False)
CFGS = {"hybrid": tiny_hybrid, "xlstm": tiny_xlstm}
PAD = 32        # the reference forward's one length: prompt + new tokens


@functools.lru_cache(maxsize=None)
def _forward(name: str):
    jm, jp, _, _ = models(CFGS[name]())
    fwd = jax.jit(jm.forward)
    return lambda toks: fwd(jp, toks)


def _reference(name: str, prompts, max_new: int):
    """JAX's cache-free greedy streams (reference_generate's loop: the
    full forward over the growing sequence, argmax of its last logits),
    by prompt."""
    fwd, out = _forward(name), {}
    for p in prompts:
        toks = list(p)
        assert len(toks) + max_new <= PAD
        for _ in range(max_new):
            padded = np.zeros((1, PAD), np.int32)
            padded[0, :len(toks)] = toks
            logits, _, _ = fwd(jnp.asarray(padded))
            toks.append(int(jnp.argmax(logits[0, len(toks) - 1])))
        out[tuple(p)] = toks[len(p):]
    return out


def _jobs(n: int, seed: int, max_new: int):
    rng = np.random.default_rng(seed)
    return [(tuple(int(t) for t in rng.integers(1, 250, int(rng.integers(
        4, 20)))), max_new) for _ in range(n)]


def _assert_reference_streams(name, got, jobs, max_new):
    want = _reference(name, tuple(p for p, _ in jobs), max_new)
    for rid, (prompt, _) in enumerate(jobs):
        assert got["outputs"][rid] == want[prompt], rid


@pytest.mark.parametrize("sched", SCHEDS)
@pytest.mark.parametrize("name", list(CFGS))
def test_engine_matches_jax_engine_without_slot_reuse(name, sched):
    jobs = [(p, 6) for p in PROMPTS]
    want = parity.run("jax", CFGS[name](), sched, jobs=jobs, **OFF)
    got = parity.run("torch", CFGS[name](), sched, jobs=jobs, **OFF)
    parity.assert_same(got, want, ["plans", "outputs", "ttft",
                                   "token_times", "iterations"])


def test_more_requests_than_slots_start_from_fresh_state():
    """Six requests on two slots: every slot is reused, and each stream is
    the cache-free forward's (the JAX engine's is not)."""
    jobs = _jobs(6, 3, 6)
    kw = dict(sched_kw=dict(n_slots=2), n_slots=2, **OFF)
    got = parity.run("torch", tiny_hybrid(), "layered", jobs=jobs, **kw)
    want = parity.run("jax", tiny_hybrid(), "layered", jobs=jobs, **kw)
    assert got["plans"] == want["plans"]
    _assert_reference_streams("hybrid", got, jobs, 6)


@pytest.mark.parametrize("name", list(CFGS))
def test_recompute_preemption_streams_equal_the_model(name):
    """An oversubscribed page pool evicts a request; it is re-admitted
    into a used slot and re-prefills from fresh state."""
    jobs = _jobs(8, 5, 6)
    kw = dict(max_len=64, pages=14 if name == "hybrid" else 12, page_size=4,
              decode_reserve=1, **OFF)
    got = parity.run("torch", CFGS[name](), "layered", jobs=jobs, **kw)
    want = parity.run("jax", CFGS[name](), "layered", jobs=jobs, **kw)
    assert got["n_preempted"] > 0
    assert got["plans"] == want["plans"]
    _assert_reference_streams(name, got, jobs, 6)


def test_swap_preemption_restores_the_whole_state():
    """A swapped-out request's recurrent state goes to host memory and
    comes back whole (not its first positions)."""
    jobs = _jobs(8, 5, 10)
    kw = dict(max_len=64, pages=16, page_size=4, decode_reserve=1,
              preemption_mode="swap", **OFF)
    got = parity.run("torch", tiny_hybrid(), "layered", jobs=jobs, **kw)
    want = parity.run("jax", tiny_hybrid(), "layered", jobs=jobs, **kw)
    assert got["n_swapped_out"] == got["n_swapped_in"] > 0
    assert got["plans"] == want["plans"]
    _assert_reference_streams("hybrid", got, jobs, 10)


@pytest.mark.parametrize("streaming", [True, False], ids=["stream", "whole"])
def test_two_pools_hand_off_the_whole_state(streaming):
    """Two pools: each layer group's recurrent state (stream) or the
    whole slot (whole) moves to the decode pool, whose slots are reused;
    the handoff bytes count the state."""
    trace = [TraceRequest(0.0, len(p), n, prompt_tokens=p)
             for p, n in _jobs(6, 7, 6)]
    kw = dict(n_slots=2, sched_kw=dict(n_slots=2), **OFF)
    got = parity.run_disagg("torch", tiny_hybrid(), trace,
                            streaming=streaming, **kw)
    want = parity.run_disagg("jax", tiny_hybrid(), trace,
                             streaming=streaming, **kw)
    assert got["plans"] == want["plans"]
    assert got["handoffs"][0] == len(trace)
    jobs = [(r.prompt_tokens, r.output_len) for r in trace]
    _assert_reference_streams("hybrid", got, jobs, 6)
    _, _, tm, _ = models(tiny_hybrid())
    state = sum(v[:, 0].numel() * 4 for seg, recs in
                zip(tm.init_cache(1, 1), tm.recurrent)
                for c, rec in zip(seg, recs) if rec for v in c.values())
    for _, n_tok, _, nbytes in got["migrations"]:
        assert nbytes == n_tok * tiny_hybrid().kv_bytes_per_token(4) + state


def test_engine_refuses_prefix_cache_and_speculation():
    _, _, tm, tp = models(tiny_xlstm())
    with pytest.raises(ValueError, match="prefix"):
        Engine(tm, tp, "layered", n_slots=2, max_len=32)
    with pytest.raises(ValueError, match="spec"):
        Engine(tm, tp, "layered", n_slots=2, max_len=32, prefix_cache=False,
               spec_mode="ngram")
    Engine(tm, tp, "layered", n_slots=2, max_len=32, prefix_cache=False)
    for arch in ("recurrentgemma-9b", "xlstm-1.3b"):
        with pytest.raises(ValueError, match="recurrent"):
            ServeConfig(arch=arch, spec="ngram").validate()
        a = ServeConfig(arch=arch).validate()
        assert a.prefix_cache and not a.prefix_cache_on()
        assert a.engine_kwargs()["prefix_cache"] is False


def test_launcher_serves_recurrentgemma_with_the_prefix_cache_off(capsys):
    serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device", "cpu",
                "--requests", "3", "--slots", "2", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "recurrentgemma-9b-smoke x layered" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("[serve] mixers"))
    assert "local_gqa x1, rglru x2" in line and "prefix cache off" in line
    assert "[serve] prefix cache: hit rate" not in out
    with pytest.raises(ValueError, match="recurrent"):
        serve.main(["--arch", "recurrentgemma-9b", "--smoke", "--device",
                    "cpu", "--spec", "ngram"])
