"""Disaggregated prefill/decode serving in the port (``EngineHandoff``,
``DisaggRuntime``, the launcher's ``--disagg``), on the CPU in fp32: the
engine half of tests/test_disagg.py, plus port-vs-JAX identity on the same
weights and traces (per-pool plans, merged token streams, migrations,
returns, handoff chunks, per-pool expert bytes).

Handoff bytes differ from JAX's on purpose: the JAX engine moves each
block's whole ``max_len`` slot row, the port only the prompt's positions
(as its swap does), so per migration ``port bytes x max_len == JAX bytes
x prompt_len``.

Not ported from tests/test_disagg.py: the ``test_sim_*`` and
``test_disagg_sim_*`` tests, which drive the analytic simulator (not in
the port yet, ROADMAP §1 item 9).
"""

from __future__ import annotations

import pytest
import torch

import _torch_parity as parity
from conftest import tiny_dense, tiny_moe
from repro_torch.core.plan import RequestState
from repro_torch.launch.serve import main as serve_main
from repro_torch.serving.engine import Engine, EngineHandoff
from repro_torch.serving.runtime import DisaggRuntime, EngineExecutor
from repro_torch.serving.traffic import TraceRequest
from test_disagg import _mixed_trace as jax_mixed_trace
from test_torch_model import models

PRESSURE = dict(pages=16, page_size=4, decode_reserve=1)


def _mixed_trace(**kw):
    """tests/test_disagg.py's multi-class oversubscribed trace, as the
    port's TraceRequests."""
    return [TraceRequest(r.arrival_time, r.prompt_len, r.output_len,
                         slo_class=r.slo_class, prompt_tokens=r.prompt_tokens)
            for r in jax_mixed_trace(**kw)]


def _pair(cfg, **eng_kw):
    return parity.build_pair("torch", cfg, **eng_kw)


def _disagg(cfg, trace, *, streaming=True, **eng_kw):
    ep, ed = _pair(cfg, **eng_kw)
    rt = DisaggRuntime(EngineExecutor(ep), EngineExecutor(ed),
                       EngineHandoff(ep, ed, streaming=streaming),
                       clock="iteration")
    return ep, ed, rt.run(trace, max_iterations=100_000)


def _free_outputs(cfg, trace):
    """The unconstrained monolithic layered engine over the same prompts."""
    free = parity.build("torch", cfg, "layered")
    for tr in trace:
        free.submit(list(tr.prompt_tokens), tr.output_len)
    free.run(max_iterations=100_000)
    return free.outputs


def _assert_no_leaks(*engines):
    for e in engines:
        assert e.alloc.pages_in_use() == 0
        assert e.alloc.host_pages_in_use() == 0
        e.alloc.check_invariants()


# ------------------------------------------------- two pools vs one pool

@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_disagg_tokens_bit_identical_to_monolithic(mode):
    """Oversubscribed two-pool replay == unconstrained monolithic run,
    token for token, in both preemption modes; decode-pool recompute
    victims route back to the prefill pool, and no page leaks from either
    pool."""
    cfg = tiny_dense()
    trace = _mixed_trace()
    ep, ed, rr = _disagg(cfg, trace, preemption_mode=mode, **PRESSURE)
    assert rr.n_migrations > 0
    assert rr.decode_prefill_slices == 0
    if mode == "swap":
        assert rr.n_swap_outs > 0, "scenario must actually swap"
    else:
        assert rr.n_preemptions > 0, "scenario must actually preempt"
    assert rr.n_returns > 0, "scenario must route victims back"
    assert {**ep.outputs, **ed.outputs} == _free_outputs(cfg, trace)
    _assert_no_leaks(ep, ed)
    assert not ep._handoff_chunks and not ed._handoff_chunks


def test_disagg_whole_handoff_also_bit_identical():
    """The whole-prompt baseline is equally correct: only the transfer
    differs, never the tokens."""
    cfg = tiny_dense()
    trace = _mixed_trace(n=16, spread=20)
    ep, ed, rr = _disagg(cfg, trace, streaming=False, **PRESSURE)
    assert rr.n_migrations > 0
    assert ep.handoff_bytes == 0 and ep.n_handoffs_out == rr.n_migrations
    assert {**ep.outputs, **ed.outputs} == _free_outputs(cfg, trace)
    _assert_no_leaks(ep, ed)


def test_stream_and_whole_move_the_same_kv():
    """Streaming stages one chunk per layer group of the last pass; the
    whole-prompt fallback copies the same positions at export.  Either
    way each migration moves every layer's K/V for positions
    ``[0, prompt_len)`` and nothing else, and the decode pool's slot rows
    hold the same values."""
    cfg = tiny_dense()
    out = {}
    for streaming in (True, False):
        ep, ed = _pair(cfg)
        rid = ep.submit([5, 6, 7, 8, 9, 10, 11], 3)
        bridge = EngineHandoff(ep, ed, streaming=streaming)
        req = ep.requests[rid]
        while req.state != RequestState.DECODE:    # every layer group
            ep.step()
        ep.scheduler.pop_request(rid)
        m = bridge.export(req, 0.0)
        per_token = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim_ * 4
        assert m.bytes_total == 7 * per_token
        chunks = m.payload["chunks"]
        assert (len(chunks) > 0) == streaming
        assert sum(b1 - b0 for b0, b1, _ in chunks) == \
            (ep.model.n_blocks if streaming else 0)
        bridge.do_import(m, 0.0)
        slot = ed._slot_of[rid]
        out[streaming] = [leaf[:, slot, :7].clone() for seg in ed.cache
                          for d in seg for leaf in d.values()]
        assert ep.alloc.pages_in_use() == 0
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


# ------------------------------------------------- the port against JAX

@pytest.mark.parametrize("mode", ["recompute", "swap"])
@pytest.mark.parametrize("make_cfg", [tiny_dense, tiny_moe])
def test_disagg_matches_jax_runtime(make_cfg, mode):
    """The same oversubscribed trace through JAX's ``DisaggRuntime`` and
    the port's: identical per-pool plans, merged streams, per-request
    handoffs / chunks / preemptions / TTFTs, run counters (migrations,
    returns, per-pool iterations), per-pool expert bytes and zero leaks;
    each migration moves the prompt's positions where JAX moves the
    whole slot row."""
    cfg = make_cfg()
    trace = _mixed_trace(n=16, spread=20)
    kw = dict(PRESSURE, preemption_mode=mode)
    want = parity.run_disagg("jax", cfg, trace, **kw)
    got = parity.run_disagg("torch", cfg, trace, **kw)
    parity.assert_same(got, want, [k for k in want if k != "migrations"])
    assert got["run"]["n_migrations"] > 0
    assert got["run"]["n_returns" if mode == "recompute"
                      else "n_swap_outs"] > 0
    assert got["pages_left"] == (0, 0, 0, 0)
    assert [g[:3] for g in got["migrations"]] == \
        [w[:3] for w in want["migrations"]]
    for (_, n_tok, _, b_port), (_, _, _, b_jax) in zip(got["migrations"],
                                                       want["migrations"]):
        assert b_port * got["max_len"] == b_jax * n_tok


def test_disagg_whole_handoff_matches_jax_runtime():
    cfg = tiny_moe()
    trace = _mixed_trace(n=16, spread=20)
    want = parity.run_disagg("jax", cfg, trace, streaming=False, **PRESSURE)
    got = parity.run_disagg("torch", cfg, trace, streaming=False, **PRESSURE)
    parity.assert_same(got, want, [k for k in want if k != "migrations"])
    for (_, n_tok, n_chunks, b_port), (_, _, _, b_jax) in zip(
            got["migrations"], want["migrations"]):
        assert n_chunks == 0
        assert b_port * got["max_len"] == b_jax * n_tok


# ---------------------------------------------------- hot-path contracts

def test_one_host_sync_per_pool_iteration_with_streaming(monkeypatch):
    """Streaming handoff adds no host sync: each pool's iteration makes
    its one ``.cpu()``, export and import make none, and nothing calls
    ``.item()``/``.tolist()`` on a tensor (tiny_dense: on the CPU the
    plain ragged MoE reads its group sizes on the host)."""
    cfg = tiny_dense()
    ep, ed = _pair(cfg, **PRESSURE)
    calls, per_iter = [], []
    for name in ("cpu", "item", "tolist"):
        real = getattr(torch.Tensor, name)

        def counted(self, *a, _name=name, _real=real, **k):
            calls.append(_name)
            return _real(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    for eng in (ep, ed):
        execute = eng.execute_plan

        def execute_plan(plan, _execute=execute):
            n0 = len(calls)
            events = _execute(plan)
            per_iter.append(calls[n0:])
            del calls[n0:]
            return events
        eng.execute_plan = execute_plan
    rt = DisaggRuntime(EngineExecutor(ep), EngineExecutor(ed),
                       EngineHandoff(ep, ed, streaming=True),
                       clock="iteration")
    rr = rt.run(_mixed_trace(n=16, spread=20), max_iterations=100_000)
    assert rr.n_migrations > 0 and ep.handoff_bytes > 0
    assert len(per_iter) == rr.n_iterations
    assert all(c == ["cpu"] for c in per_iter), per_iter
    assert calls == [], calls          # export / import / supervision


# ------------------------------------------------------------ launcher

@pytest.mark.parametrize("handoff", ["stream", "whole"])
def test_launcher_disagg_on_the_cpu(handoff, capsys):
    serve_main(["--smoke", "--device", "cpu", "--disagg", "--handoff",
                handoff, "--requests", "3", "--slots", "4",
                "--max-len", "96"])
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines()
             if ln.startswith("[serve-disagg]")]
    assert lines[0].startswith(
        "[serve-disagg] qwen3-30b-a3b-smoke x layered+decode (closed-loop, "
        f"{handoff} handoff): 3 requests in ")
    assert "3 migrations (0 returns)" in lines[1]
    assert "decode-pool prefill slices 0 (must stay 0)" in lines[2]
    assert lines[3].startswith("[serve-disagg] kv high-water prefill ")
    chunks = float(lines[2].split("chunks/req ")[1].split(";")[0])
    assert (chunks > 0) == (handoff == "stream")


def test_launcher_disagg_keeps_one_copy_of_the_weights():
    from repro_torch.launch.config import ServeConfig
    from repro_torch.launch.serve import build_disagg_engines
    a = ServeConfig(smoke=True, device="cpu", slots=4, max_len=64,
                    decode_pages=40)
    ep, ed = build_disagg_engines(a)
    assert ep.model is ed.model and ep.params is ed.params
    assert ed.scheduler.name == "decode" and ed.alloc.n_pages == 40
    assert ep.cache[0][0]["k"].data_ptr() != ed.cache[0][0]["k"].data_ptr()


def test_engine_handoff_rejects_mismatched_configs():
    ep = parity.build("torch", tiny_dense(), "layered")
    _, _, tm, tp = models(tiny_moe())
    from repro_torch.core.base import make_scheduler
    ed = Engine(tm, tp, make_scheduler("decode", tm.n_blocks, n_slots=4),
                n_slots=4, max_len=64)
    with pytest.raises(ValueError, match="share the model config"):
        EngineHandoff(ep, ed)
