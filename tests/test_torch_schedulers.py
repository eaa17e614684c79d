"""All five schedulers in the port: the same tokens from every scheduler
(the port's counterpart of tests/test_engine_equivalence.py), identical
engine traces against the JAX engine for hybrid, continuous and static
batching, and identical iteration plans from the port's and the JAX
package's scheduler objects over seeded random traces."""

from __future__ import annotations

import numpy as np
import pytest

import _torch_parity as parity
from conftest import tiny_dense, tiny_moe
from repro.core.base import make_scheduler as jax_make_scheduler
from repro.core.plan import Request as JaxRequest
from repro.serving.kvcache import PagedKVAllocator as JaxAllocator
from repro_torch.core import SCHEDULERS
from repro_torch.core.base import make_scheduler
from repro_torch.core.plan import Request
from repro_torch.serving.kvcache import PagedKVAllocator
from test_torch_model import models

SCHEDS = ["continuous", "chunked", "layered", "hybrid", "static"]
PROMPTS = [list(range(1, 12)), [5, 3, 7] * 9, list(range(40, 10, -1))]


def test_port_registers_all_five_schedulers():
    assert sorted(SCHEDULERS) == sorted(SCHEDS)


def _generate(cfg, sched_name, prompts, max_new=6):
    _, _, tm, tp = models(cfg)
    from repro_torch.serving.engine import Engine
    sched = make_scheduler(sched_name, tm.n_blocks, n_slots=4, quantum=8,
                           token_budget=16)
    eng = Engine(tm, tp, sched, n_slots=4, max_len=128)
    for p in prompts:
        eng.submit(p, max_new)
    eng.run()
    return {rid: list(toks) for rid, toks in eng.outputs.items()}


@pytest.mark.parametrize("make_cfg", [tiny_dense, tiny_moe],
                         ids=["dense", "moe"])
def test_all_schedulers_agree(make_cfg):
    cfg = make_cfg()
    base = _generate(cfg, "continuous", PROMPTS)
    for name in SCHEDS[1:]:
        got = _generate(cfg, name, PROMPTS)
        assert got == base, f"{name} diverged from continuous on {cfg.name}"


# six requests into 12 four-token pages: recompute preemption under every
# scheduler; a deeper stack so hybrid and layered split into groups
CFG = tiny_moe(n_layers=4)
PRESSURE = dict(pages=12, page_size=4, decode_reserve=1)


def _jobs():
    rng = np.random.default_rng(0)
    return [(rng.integers(1, 200, int(rng.integers(4, 24))).tolist(), 8)
            for _ in range(6)]


@pytest.mark.parametrize("sched", ["hybrid", "continuous", "static"])
def test_engine_trace_matches_jax_engine(sched):
    """Identical plans, tokens, TTFTs, token times, expert bytes,
    preemptions and dispatches; every page returned."""
    want = parity.run("jax", CFG, sched, jobs=_jobs(), **PRESSURE)
    got = parity.run("torch", CFG, sched, jobs=_jobs(), **PRESSURE)
    parity.assert_same(got, want)
    assert got["pages_left"] == 0
    assert all(len(t) == 8 for t in got["outputs"].values())
    assert got["n_preempted"] > 0, "the trace must force preemption"


def test_hybrid_slices_partial_in_tokens_and_blocks():
    """A long prompt under hybrid prefill runs slices that cover part of
    the tokens AND part of the blocks (the boundary stash then carries a
    token range through several groups); port and JAX agree."""
    rng = np.random.default_rng(5)
    jobs = [(rng.integers(1, 200, 40).tolist(), 4),
            (rng.integers(1, 200, 9).tolist(), 4)]
    kw = dict(sched_kw=dict(quantum=8, token_budget=24), max_len=64)
    want = parity.run("jax", CFG, "hybrid", jobs=jobs, **kw)
    got = parity.run("torch", CFG, "hybrid", jobs=jobs, **kw)
    parity.assert_same(got, want)
    n_blocks = CFG.n_layers
    partial = [s for plan in got["plans"] for s in plan[5]
               if s[2] - s[1] < 40 and s[4] - s[3] < n_blocks and s[0] == 0]
    assert partial, "hybrid must split the long prompt in tokens and blocks"


# --------------------------------------------------- pure scheduler sweep


def _drive(pkg: str, sched: str, reqs, mode: str, seed: int):
    """Plans of one scheduler object over ``reqs`` ((arrival, prompt_len,
    max_new, class) rows submitted at their arrival iteration) in a small
    paged pool under ``mode`` preemption."""
    mk, alloc_cls, req_cls = ((jax_make_scheduler, JaxAllocator, JaxRequest)
                              if pkg == "jax" else
                              (make_scheduler, PagedKVAllocator, Request))
    s = mk(sched, 6, n_slots=4, quantum=16, token_budget=32)
    kv = alloc_cls(24, 4, stash_factor=0.25,
                   n_host_pages=0 if mode == "recompute" else 160,
                   prefix_caching=False)
    s.attach_kv(kv, decode_reserve=2, mode=mode)
    pending = sorted(reqs)
    plans, it = [], 0
    while pending or s.has_work():
        while pending and pending[0][0] <= it:
            arr, n, new, cls, rid = pending.pop(0)
            s.submit(req_cls(req_id=rid, prompt_len=n, max_new_tokens=new,
                             arrival_time=float(arr), slo_class=cls))
        plans.append(parity.plan_key(s.next_plan(now=float(it))))
        it += 1
        assert it < 5000
    done = sorted((r.req_id, r.n_generated, r.n_preemptions, r.n_swaps)
                  for r in s.requests.values())
    return plans, done, kv.pages_in_use()


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("sched", SCHEDS)
def test_scheduler_plans_match_jax(sched, seed):
    rng = np.random.default_rng(100 + seed)
    mode = ("recompute", "swap", "auto", "recompute")[seed]
    reqs = [(int(rng.integers(0, 15)), int(rng.integers(3, 50)),
             int(rng.integers(1, 16)),
             "batch" if rng.random() < 0.3 else "interactive", i)
            for i in range(int(rng.integers(12, 24)))]
    got = _drive("torch", sched, reqs, mode, seed)
    want = _drive("jax", sched, reqs, mode, seed)
    assert got == want
    assert got[2] == 0
