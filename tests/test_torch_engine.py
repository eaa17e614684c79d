"""The port's serving engine against the JAX engine on the CPU in fp32.

One multi-request trace runs through ``repro.serving.engine.Engine(...,
prefix_cache=False)`` and through ``repro_torch.serving.engine.Engine`` on
the iteration clock, under layered and chunked prefill, in a KV pool small
enough to force recompute preemption.  The iteration plans, the token
streams and ``expert_load_bytes`` must be identical, and layered prefill
must load no more expert bytes than chunked.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_moe
from repro.core.base import make_scheduler as jax_make_scheduler
from repro.models.model import DecoderModel as JaxModel
from repro.serving.engine import Engine as JaxEngine
from repro.serving.runtime import EngineExecutor as JaxExecutor
from repro.serving.runtime import ServingRuntime as JaxRuntime
from repro_torch.core.base import make_scheduler
from repro_torch.models.model import DecoderModel
from repro_torch.serving.engine import Engine, _bucket
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from test_torch_model import models, port_cfg

CFG = tiny_moe(n_layers=4)
# a pool of 16 four-token pages against six requests: both schedulers
# must preempt (recompute) at least once
ENGINE_KW = dict(n_slots=4, max_len=64, pages=16, page_size=4,
                 decode_reserve=1)


def _jobs():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 200, int(rng.integers(4, 24))).tolist(), 8)
            for _ in range(6)]


def _plan_key(plan):
    return (plan.admitted_ids, plan.preempted_ids, plan.decode_ids,
            [(s.req_id, s.token_start, s.token_end, s.block_start,
              s.block_end, s.emits_first_token) for s in plan.prefill])


@functools.lru_cache(maxsize=None)
def _run(framework: str, sched: str):
    jm, jp, tm, tp = models(CFG)
    if framework == "jax":
        s = jax_make_scheduler(sched, jm.n_blocks, n_slots=4, quantum=8,
                               token_budget=16)
        eng = JaxEngine(jm, jp, s, prefix_cache=False, **ENGINE_KW)
        runtime = JaxRuntime(JaxExecutor(eng), clock="iteration",
                             record_plans=True)
    else:
        s = make_scheduler(sched, tm.n_blocks, n_slots=4, quantum=8,
                           token_budget=16)
        eng = Engine(tm, tp, s, **ENGINE_KW)
        runtime = ServingRuntime(EngineExecutor(eng), clock="iteration",
                                 record_plans=True)
    for prompt, max_new in _jobs():
        eng.submit(prompt, max_new)
    res = runtime.run((), max_iterations=1000)
    ttft = {r.req_id: r.first_token_time for r in res.requests}
    return {"plans": [_plan_key(p) for p in runtime.plans],
            "outputs": {rid: list(map(int, t)) for rid, t in eng.outputs.items()},
            "expert_load_bytes": eng.expert_load_bytes,
            "n_preempted": eng.n_preempted, "n_dispatches": eng.n_dispatches,
            "ttft": ttft, "pages_left": eng.alloc.pages_in_use()}


@pytest.mark.parametrize("sched", ["layered", "chunked"])
def test_engine_trace_matches_jax_engine(sched):
    want, got = _run("jax", sched), _run("torch", sched)
    assert got["n_preempted"] > 0, "the trace must force recompute preemption"
    assert got["plans"] == want["plans"]
    assert got["outputs"] == want["outputs"]
    assert got["expert_load_bytes"] == want["expert_load_bytes"]
    assert got["n_preempted"] == want["n_preempted"]
    assert got["n_dispatches"] == want["n_dispatches"]
    assert got["ttft"] == want["ttft"]
    assert got["pages_left"] == 0
    assert all(len(t) == 8 for t in got["outputs"].values())


def test_layered_loads_no_more_expert_bytes_than_chunked():
    lay, chk = _run("torch", "layered"), _run("torch", "chunked")
    assert lay["outputs"] == chk["outputs"]
    assert lay["expert_load_bytes"] <= chk["expert_load_bytes"]


def test_engine_eos_early_exit():
    _, _, tm, tp = models(CFG)
    first = _run("torch", "layered")["outputs"][0][0]
    eng = Engine(tm, tp, "layered", n_slots=2, max_len=64, eos_token=first)
    rid = eng.submit(_jobs()[0][0], 20)
    eng.run()
    assert eng.outputs[rid] == [first]
    assert eng.requests[rid].finish_time is not None


def test_unported_options_raise():
    _, _, tm, tp = models(CFG)
    for kw in (dict(prefix_cache=True), dict(spec_mode="ngram"),
               dict(preemption_mode="swap"), dict(moe_dispatch="dense")):
        with pytest.raises(NotImplementedError):
            Engine(tm, tp, "layered", n_slots=2, max_len=64, **kw)
    eng = Engine(tm, tp, "layered", n_slots=2, max_len=64)
    from repro_torch.core.plan import SubmitSpec
    with pytest.raises(NotImplementedError):
        eng.submit_spec(SubmitSpec(max_new_tokens=2, prompt_tokens=[1, 2],
                                   enc_frames=np.zeros((4, 64))))


def test_bucket_capped_at_max_len():
    assert _bucket(5) == 16
    assert _bucket(17) == 32
    assert _bucket(100, cap=112) == 112
    assert _bucket(100, cap=64) == 100
    assert _bucket(60, cap=96) == 64


def test_engine_needs_cuda_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecoderModel(port_cfg(CFG))
    assert JaxModel(CFG).n_blocks == DecoderModel(port_cfg(CFG),
                                                  device="cpu").n_blocks
    assert jax.devices()[0].platform == "cpu"
