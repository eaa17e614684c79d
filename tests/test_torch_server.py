"""The port's HTTP/SSE front-end (``repro_torch/serving/server.py``), its
rate limiter, its load generator and the SubmitSpec/ServeConfig ingestion
API, held against the JAX package: every test of ``tests/test_server.py``
and the three server tests of ``tests/test_faults.py``, run against the
port's server on tiny_dense in fp32 on the CPU, with the JAX engine's
offline replay as the reference where tokens are compared (the same
weights: the JAX init converted through ``repro_torch.convert``).

The acceptance bar is the JAX package's: requests submitted CONCURRENTLY
over sockets while the engine loop runs on its own wall-clock thread must
stream tokens bit-identical to an offline iteration-clock replay of the
same trace — the port's own and the JAX engine's — under memory pressure,
in both preemption flavours.  On top of it: a replay of the server's
admission log reproduces the live plans exactly (how a bf16 serve on the
card is held bit for bit), and no handler on the asyncio thread touches a
tensor (a sync from that thread would stall the card's queue)."""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

try:
    from hypothesis import HealthCheck, given, settings, strategies as st
    # hypothesis's checks on wall time: a host stall (a loaded CPU, a
    # garbage collection of the worker's models) is no fault of the test
    HOST_TIMED = dict(deadline=None, suppress_health_check=[
        HealthCheck.too_slow])
except ImportError:          # degrade to a deterministic seeded sweep
    from _hypothesis_fallback import given, settings, strategies as st
    HOST_TIMED = {}

from _torch_parity import run as parity_run
from conftest import tiny_dense
from repro.launch.config import ServeConfig as JaxServeConfig
from repro_torch.core.plan import Request, SubmitSpec
from repro_torch.launch import load_gen
from repro_torch.launch.config import ServeConfig
from repro_torch.launch.load_gen import (_fetch, _post_generate,
                                         check_admission_replay,
                                         replay_admissions, run_load,
                                         verify_identity)
from repro_torch.launch.serve import build_engine
from repro_torch.serving.ratelimit import TenantRateLimiter, TokenBucket
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
from repro_torch.serving.server import ServingServer
from repro_torch.serving.traffic import TraceRequest
from test_torch_model import models

# the engine of tests/test_server.py: tiny_dense, layered, 4 slots of 64
BASE = ServeConfig(scheduler="layered", slots=4, quantum=8, token_budget=16,
                   max_len=64, device="cpu")
PRESSURE = dict(pages=16, page_size=4, decode_reserve=1)
PORT_ONLY = {"dtype", "device", "prompt_len", "new_tokens"}


def _weights():
    _, _, tm, tp = models(tiny_dense())
    return tm, tp


def _config(mode: str = "recompute", **kw) -> ServeConfig:
    if mode != "recompute":
        kw["preemption"] = mode
    return dataclasses.replace(BASE, **kw)


def _make_engine(sc: ServeConfig = BASE):
    return build_engine(sc, *_weights())


def _trace(n=12, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        n_tok = int(rng.integers(4, 10))
        out.append(TraceRequest(
            arrival_time=float(i), prompt_len=n_tok,
            output_len=int(rng.integers(6, 11)),
            slo_class="batch" if i % 3 == 0 else "interactive",
            prompt_tokens=tuple(int(x)
                                for x in rng.integers(1, 200, n_tok))))
    return out


def _offline_tokens(trace, sc: ServeConfig = BASE):
    eng = _make_engine(sc)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    res = rt.run(trace, max_iterations=100_000)
    return [list(eng.outputs[r.req_id]) for r in res.requests]


def _jax_offline_tokens(trace, mode: str = "recompute", **kw):
    """The JAX engine's offline replay of ``trace`` on the same weights,
    per trace index (arrivals are distinct and ascending, so request ids
    are trace indices)."""
    if mode != "recompute":
        kw["preemption_mode"] = mode
    out = parity_run("jax", tiny_dense(), "layered", trace=trace,
                     **kw)["outputs"]
    return [out[i] for i in range(len(trace))]


async def _with_server(body, sc: ServeConfig = BASE, **server_kw):
    """Start a ServingServer on an OS port, run ``body(srv)``, stop."""
    eng = server_kw.pop("engine", None) or _make_engine(sc)
    srv = ServingServer(eng, port=0, **server_kw)
    await srv.start()
    try:
        return await body(srv)
    finally:
        await srv.stop()


# ------------------------------------------------------- token identity


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_concurrent_http_submit_matches_offline_replay(mode):
    """Concurrent socket submissions during a live wall-clock run, under
    an oversubscribed pool, must stream tokens bit-identical to the
    port's offline iteration-clock replay — and that replay equals the
    JAX engine's on the same weights — in both modes."""
    sc = _config(mode, **PRESSURE)
    trace = _trace(n=10)
    offline = _offline_tokens(trace, sc)
    assert offline == _jax_offline_tokens(trace, mode, **PRESSURE)

    async def body(srv):
        return await run_load(srv.host, srv.port, trace, n_clients=5)

    report = asyncio.run(_with_server(body, sc))
    assert all(r.status == 200 for r in report.results)
    assert verify_identity(report, offline) == 0


@pytest.mark.parametrize("mode", ["recompute", "swap"])
def test_admission_log_replay_reproduces_live_plans(mode):
    """A replay of the server's admission log — each spec arriving at the
    engine iteration at which it entered the live scheduler — through a
    fresh engine on the same weights, on the iteration clock, plans
    exactly what the live run planned and gives its streams: the check
    that holds a bf16 serve on the card bit for bit."""
    sc = _config(mode, **PRESSURE)
    tm, tp = _weights()
    trace = _trace(n=10, seed=1)

    async def body(srv):
        report = await run_load(srv.host, srv.port, trace, n_clients=5)
        return srv, report

    srv, report = asyncio.run(_with_server(
        body, sc, engine=build_engine(sc, tm, tp), record_plans=True))
    assert all(r.status == 200 for r in report.results)
    assert sorted(rid for rid, _, _ in srv.admission_log) \
        == list(range(len(trace)))
    replay = replay_admissions(sc, srv.admission_log, tm, tp)
    assert replay["plans"] == [load_gen.plan_key(p)
                               for p in srv.runtime.plans]
    assert check_admission_replay(replay["plans"], srv.engine.outputs,
                                  replay) == 0
    assert replay["outputs"] == {rid: list(t) for rid, t
                                 in srv.engine.outputs.items()}


def test_sse_stream_order_matches_on_token_order():
    """Per-request SSE token events must arrive in exactly the engine's
    on_token emission order, contiguously indexed from 0, and equal the
    done event's full list and the engine's recorded outputs."""
    async def body(srv):
        tr = _trace(n=1)[0]
        status, _, events = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": list(tr.prompt_tokens),
             "max_new_tokens": tr.output_len})
        assert status == 200
        toks = [d["token"] for k, d in events if k == "token"]
        idxs = [d["index"] for k, d in events if k == "token"]
        done = [d for k, d in events if k == "done"]
        assert idxs == list(range(len(toks)))
        assert len(done) == 1 and events[-1][0] == "done"
        assert toks == done[0]["tokens"]
        rid = done[0]["req_id"]
        assert [t for r, t in srv.token_log if r == rid] == toks
        assert list(srv.engine.outputs[rid]) == toks

    asyncio.run(_with_server(body))


def test_non_streaming_json_response():
    async def body(srv):
        tr = _trace(n=1)[0]
        status, _, events = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": list(tr.prompt_tokens),
             "max_new_tokens": tr.output_len, "stream": False})
        assert status == 200
        kind, doc = events[0]
        assert kind == "json"
        assert doc["tokens"] == list(srv.engine.outputs[doc["req_id"]])
        assert doc["n_generated"] == len(doc["tokens"])

    asyncio.run(_with_server(body))


class _TensorReads(TorchFunctionMode):
    """Records every torch function and Tensor method or attribute the
    current thread calls while active (torch keeps the mode per thread,
    so the engine thread's work is not recorded)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.calls.append(getattr(func, "__name__", repr(func)))
        return func(*args, **(kwargs or {}))


def test_asyncio_thread_reads_no_tensor():
    """Every handler that runs on the asyncio thread — POST and SSE
    streaming, the done summary, /metrics, /healthz, /readyz, the 429
    gate (rate limit, queue depth, pool share) and drain — reads the
    engine's host state only: not one torch call on that thread while the
    engine serves on its own.  The streams are Python ints."""
    trace = _trace(n=6, seed=2)

    async def body(srv):
        with _TensorReads() as reads:
            report = await run_load(srv.host, srv.port, trace, n_clients=3)
            # the rate limit from here on (run_load's tenants are classes)
            srv.limiter = TenantRateLimiter(0.01, 1.0)
            status, text = await _fetch(srv.host, srv.port, "/metrics")
            assert status == 200 and b"repro_ttft" in text
            for path in ("/healthz", "/readyz"):
                assert (await _fetch(srv.host, srv.port, path))[0] == 200
            assert srv.overloaded() is None and srv.queue_depth() == 0
            srv.queue_watermark, srv.pool_watermark = 0, 1.0
            status, headers, _ = await _post_generate(
                srv.host, srv.port,
                {"prompt_tokens": [1, 2, 3], "max_new_tokens": 4})
            assert status == 429 and int(headers["retry-after"]) >= 1
            srv.queue_watermark, srv.pool_watermark = 64, 0.125
            for _ in range(2):                  # tenant "a": burst 1
                status, _, _ = await _post_generate(
                    srv.host, srv.port,
                    {"prompt_tokens": [4, 5, 6], "max_new_tokens": 3,
                     "tenant": "a", "stream": False})
            assert status == 429
            await srv.drain(timeout=5.0)
        assert reads.calls == [], reads.calls
        return report

    report = asyncio.run(_with_server(body))
    assert all(r.status == 200 for r in report.results)


# --------------------------------------------------------- backpressure


def test_backpressure_429_with_retry_after():
    """Watermarks set to 'always overloaded' must answer 429 with a
    positive integer Retry-After and never enqueue the request."""
    async def body(srv):
        tr = _trace(n=1)[0]
        status, headers, events = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": list(tr.prompt_tokens),
             "max_new_tokens": 4})
        assert status == 429
        assert int(headers["retry-after"]) >= 1
        assert events[0][1]["error"] == "overloaded"
        assert len(srv.engine.requests) == 0

    asyncio.run(_with_server(body, queue_watermark=0, pool_watermark=1.0))


def test_backpressure_429_under_oversubscribed_pool():
    """Organic overload: a 16-page pool holding ~2 residents with 8
    long-running concurrent streams must trip the queue+pool watermark
    and 429 a probe request while saturated — and still complete every
    admitted stream correctly afterwards (the JAX engine's tokens)."""
    sc = _config(**PRESSURE)
    trace = _trace(n=8, seed=3)
    offline = _offline_tokens(trace, sc)
    assert offline == _jax_offline_tokens(trace, **PRESSURE)

    async def body(srv):
        streams = [asyncio.ensure_future(_post_generate(
            srv.host, srv.port,
            {"prompt_tokens": list(tr.prompt_tokens),
             "max_new_tokens": tr.output_len, "tag": i}))
            for i, tr in enumerate(trace)]
        saw_429 = None
        probe = {"prompt_tokens": [1, 2, 3], "max_new_tokens": 4,
                 "stream": False}
        for _ in range(200):
            status, headers, _ = await _post_generate(
                srv.host, srv.port, probe)
            if status == 429:
                saw_429 = headers
                break
            await asyncio.sleep(0.01)
        done = await asyncio.gather(*streams)
        assert saw_429 is not None, "never saturated"
        assert int(saw_429["retry-after"]) >= 1
        by_tag = {}
        for status, _, events in done:
            assert status == 200
            final = [d for k, d in events if k == "done"][0]
            by_tag[final["tag"]] = [d["token"] for k, d in events
                                    if k == "token"]
        for i in range(len(trace)):
            assert by_tag[i] == offline[i], i

    asyncio.run(_with_server(body, sc, queue_watermark=2,
                             pool_watermark=0.9))


def test_ratelimit_429_per_tenant():
    """burst=1: a tenant's second immediate request is rate-limited, a
    DIFFERENT tenant's is not; Retry-After reflects the refill deficit."""
    async def body(srv):
        tr = _trace(n=1)[0]
        payload = {"prompt_tokens": list(tr.prompt_tokens),
                   "max_new_tokens": 4, "tenant": "a", "stream": False}
        s1, _, _ = await _post_generate(srv.host, srv.port, payload)
        s2, h2, ev2 = await _post_generate(srv.host, srv.port, payload)
        s3, _, _ = await _post_generate(
            srv.host, srv.port, dict(payload, tenant="b"))
        assert (s1, s2, s3) == (200, 429, 200)
        assert ev2[0][1]["error"] == "rate limited"
        assert int(h2["retry-after"]) >= 1
        counters = srv.limiter.counters()
        assert counters["a"]["rejected"] == 1
        assert counters["b"]["granted"] == 1

    asyncio.run(_with_server(body, ratelimit_rate=0.01,
                             ratelimit_burst=1.0))


def test_bad_request_400_and_metrics_and_healthz():
    async def body(srv):
        status, _, events = await _post_generate(
            srv.host, srv.port, {"max_new_tokens": 4})   # no prompt
        assert status == 400 and "bad request" in events[0][1]["error"]
        tr = _trace(n=1)[0]
        status, _, _ = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": list(tr.prompt_tokens),
             "max_new_tokens": 4, "stream": False})
        assert status == 200
        status, body_bytes = await _fetch(srv.host, srv.port, "/metrics")
        text = body_bytes.decode()
        assert status == 200
        for family in ("repro_requests_completed", "repro_ttft",
                       "repro_tbt", "repro_queue_depth",
                       "repro_kv_pages_total",
                       "repro_http_responses_total"):
            assert family in text, family
        assert 'quantile="0.99"' in text
        assert "nan" not in text.lower()
        status, _ = await _fetch(srv.host, srv.port, "/healthz")
        assert status == 200
        status, _ = await _fetch(srv.host, srv.port, "/nope")
        assert status == 404

    asyncio.run(_with_server(body))


# ------------------------------------------------------------- keep-alive


async def _raw(writer, reader, method, path, payload=None, keep=True):
    """One request over an ALREADY-OPEN connection; returns (status,
    headers, body) parsed by Content-Length so the socket can be reused."""
    body = b"" if payload is None else json.dumps(payload).encode()
    head = f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
    if keep:
        head += "Connection: keep-alive\r\n"
    if body:
        head += f"Content-Length: {len(body)}\r\n"
    writer.write(head.encode() + b"\r\n" + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    headers = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    n = int(headers.get("content-length", "0") or 0)
    return status, headers, await reader.readexactly(n) if n else b""


def test_http_keepalive_reuses_connection():
    """Connection: keep-alive must serve multiple requests over ONE
    socket — mixed POST /v1/generate (non-streaming) and GETs — with the
    keep-alive echoed in every response; a request WITHOUT the header
    gets Connection: close and the server really closes."""
    async def body(srv):
        tr = _trace(n=1)[0]
        payload = {"prompt_tokens": list(tr.prompt_tokens),
                   "max_new_tokens": 4, "stream": False}
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        for _ in range(2):
            status, headers, doc = await _raw(
                writer, reader, "POST", "/v1/generate", payload)
            assert status == 200
            assert headers["connection"] == "keep-alive"
            assert b"tokens" in doc
        status, headers, _ = await _raw(writer, reader, "GET", "/healthz")
        assert status == 200 and headers["connection"] == "keep-alive"
        status, headers, _ = await _raw(writer, reader, "GET", "/healthz",
                                        keep=False)
        assert status == 200 and headers["connection"] == "close"
        assert await reader.read() == b""          # EOF
        writer.close()
        assert srv._status_counts[200] == 4

    asyncio.run(_with_server(body))


def test_http_keepalive_idle_timeout_closes():
    """An idle keep-alive connection must be closed once
    ``keepalive_timeout`` expires — idle sockets cannot pin the server."""
    async def body(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        status, headers, _ = await _raw(writer, reader, "GET", "/healthz")
        assert status == 200 and headers["connection"] == "keep-alive"
        got = await asyncio.wait_for(reader.read(), timeout=5.0)
        assert got == b""                          # server-side close
        writer.close()

    asyncio.run(_with_server(body, keepalive_timeout=0.2))


# ------------------------------------------------- degradation and drain


async def _open_sse(host, port, payload):
    """POST /v1/generate over a raw socket, consume the response head,
    return the live (reader, writer) mid-stream."""
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
        pass
    return reader, writer, status


def test_readyz_reflects_degradation_ladder():
    """/readyz flips to 503 once the ladder refuses new interactive
    work, and interactive POSTs are answered 503 at the front door."""
    async def body(srv):
        status, _ = await _fetch(srv.host, srv.port, "/readyz")
        assert status == 200
        lad = srv.runtime.ladder
        for it in range(1, 5):                 # one rung per iteration
            for _ in range(lad.trip):
                lad.record_pressure(it)
            lad.step(it)
        assert lad.level == "interactive_503" and lad.refuse_new
        status, raw = await _fetch(srv.host, srv.port, "/readyz")
        assert status == 503 and b"degraded" in raw
        status, headers, events = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 503
        assert events[0][1]["error"].startswith("degraded")
        assert int(headers["retry-after"]) >= 1
        it = 4
        while lad.level != "normal":           # quiet cool-down recovers
            it += lad.cool
            lad.step(it)
        status, _ = await _fetch(srv.host, srv.port, "/readyz")
        assert status == 200

    asyncio.run(_with_server(body))


def test_drain_gates_ingestion_and_finishes_inflight():
    """While draining, /readyz fails and new POSTs answer 503; a stream
    already in flight when drain() is called completes intact, and the
    listener is torn down afterwards."""
    async def body(srv):
        srv._draining = True                   # the gate, deterministically
        status, raw = await _fetch(srv.host, srv.port, "/readyz")
        assert status == 503 and b"draining" in raw
        status, _, events = await _post_generate(
            srv.host, srv.port,
            {"prompt_tokens": [1, 2, 3], "max_new_tokens": 4})
        assert status == 503 and events[0][1]["error"] == "draining"
        srv._draining = False
        status, _ = await _fetch(srv.host, srv.port, "/readyz")
        assert status == 200

        fut = asyncio.ensure_future(_post_generate(
            srv.host, srv.port,
            {"prompt_tokens": [5, 6, 7, 8], "max_new_tokens": 24}))
        await asyncio.sleep(0.3)               # let it register a stream
        await srv.drain()
        status, _, events = await fut
        assert status == 200
        done = [d for k, d in events if k == "done"][0]
        assert "shed_reason" not in done and done["n_generated"] == 24
        with pytest.raises(OSError):
            await asyncio.open_connection(srv.host, srv.port)

    asyncio.run(_with_server(body, drain_timeout=60.0))


def test_sse_client_disconnect_cancels_and_frees_kv():
    """A client vanishing mid-SSE must cancel its generation: the engine
    thread sheds the request with reason 'disconnect', every KV page
    comes back, and the shed shows up in /metrics."""
    async def body(srv):
        reader, writer, status = await _open_sse(
            srv.host, srv.port,
            {"prompt_tokens": [9, 8, 7, 6, 5, 4], "max_new_tokens": 40})
        assert status == 200
        seen = 0
        while seen < 2:                        # two tokens, then vanish
            line = await reader.readline()
            assert line, "stream ended before any tokens"
            if line.startswith(b"event: token"):
                seen += 1
        writer.transport.abort()               # RST, not a polite FIN

        req = None
        for _ in range(1000):
            reqs = list(srv.engine.requests.values())
            if reqs and reqs[0].shed_reason == "disconnect" \
                    and srv.engine.alloc.pages_in_use() == 0:
                req = reqs[0]
                break
            await asyncio.sleep(0.01)
        assert req is not None, "disconnect never shed the request"
        assert req.n_generated < 40
        assert srv.n_dropped_streams == 1
        assert srv.n_shed_streams == 1
        assert srv.runtime.n_disconnect_sheds == 1
        srv.engine.alloc.check_invariants()
        status, raw = await _fetch(srv.host, srv.port, "/metrics")
        text = raw.decode()
        assert "repro_sheds_disconnect_total 1" in text
        assert "repro_shed_streams_total 1" in text

    asyncio.run(_with_server(body))


# ----------------------------------------------------------- rate limiter


@settings(max_examples=30, **HOST_TIMED)
@given(st.floats(0.1, 50.0), st.floats(0.5, 20.0),
       st.lists(st.tuples(st.floats(0.0, 2.0), st.floats(0.1, 3.0)),
                min_size=1, max_size=40))
def test_token_bucket_conservation(rate, burst, steps):
    """Over ANY acquire sequence spanning T seconds a bucket can never
    grant more than burst + rate*T tokens' worth of cost, and a rejection
    reports exactly the time until the deficit refills."""
    now = [0.0]
    tb = TokenBucket(rate, burst, clock=lambda: now[0])
    granted_cost = 0.0
    for dt, cost in steps:
        now[0] += dt
        cost = min(cost, burst)
        wait = tb.acquire(cost)
        if wait == 0.0:
            granted_cost += cost
        else:
            now[0] += wait + 1e-9
            assert tb.acquire(cost) == 0.0
            granted_cost += cost
    assert granted_cost <= burst + rate * now[0] + 1e-6


def test_token_bucket_validation_and_tenants():
    with pytest.raises(ValueError):
        TokenBucket(0.0, 1.0)
    with pytest.raises(ValueError):
        TokenBucket(1.0, -1.0)
    tb = TokenBucket(1.0, 2.0, clock=lambda: 0.0)
    with pytest.raises(ValueError):
        tb.acquire(3.0)                     # can never fit the burst
    now = [0.0]
    rl = TenantRateLimiter(1.0, 1.0, clock=lambda: now[0])
    assert rl.acquire("x") == 0.0
    assert rl.acquire("x") > 0.0            # x drained
    assert rl.acquire("y") == 0.0           # y fresh
    now[0] += 1.0
    assert rl.acquire("x") == 0.0           # refilled


# ------------------------------------------------- SubmitSpec / ServeConfig


def test_submit_spec_unifies_ingestion_paths():
    """TraceRequest.to_spec, Engine.submit, Engine.submit_spec and the
    HTTP body all converge on the same frozen SubmitSpec."""
    tr = _trace(n=1)[0]
    spec = tr.to_spec()
    assert spec.prompt_len == tr.prompt_len
    assert spec.prompt_tokens == tr.prompt_tokens
    assert spec.arrival_time == tr.arrival_time
    assert spec.tenant == spec.slo_class    # tenant defaults to the class

    with pytest.raises(ValueError):
        SubmitSpec(max_new_tokens=0, prompt_len=4)
    with pytest.raises(ValueError):
        SubmitSpec(max_new_tokens=4)        # no length at all
    s = SubmitSpec(max_new_tokens=4, prompt_tokens=[1, 2, 3])
    assert s.prompt_len == 3 and isinstance(s.prompt_tokens, tuple)

    eng = _make_engine()
    rid_legacy = eng.submit([1, 2, 3, 4], max_new_tokens=5,
                            slo_class="batch")
    req = eng.submit_spec(SubmitSpec(
        max_new_tokens=5, prompt_tokens=(1, 2, 3, 4), slo_class="batch"))
    legacy, unified = eng.requests[rid_legacy], req
    assert (legacy.prompt_len, legacy.max_new_tokens, legacy.slo_class) \
        == (unified.prompt_len, unified.max_new_tokens, unified.slo_class)
    r2 = eng.submit_spec(SubmitSpec(
        max_new_tokens=4, prompt_tokens=(5, 6, 7), prefix_cache=False,
        speculative=False))
    assert r2.cacheable_prompt is None and not r2.use_speculation
    with pytest.raises(ValueError):
        eng.submit_spec(SubmitSpec(max_new_tokens=4, prompt_len=8))


def test_request_from_spec_round_trip():
    spec = SubmitSpec(max_new_tokens=6, prompt_tokens=(9, 8, 7),
                      slo_class="batch", tenant="acme",
                      arrival_time=3.5)
    r = Request.from_spec(spec, req_id=7, arrival_time=spec.arrival_time)
    assert (r.req_id, r.prompt_len, r.max_new_tokens) == (7, 3, 6)
    assert (r.slo_class, r.tenant, r.arrival_time) \
        == ("batch", "acme", 3.5)


def test_serve_config_round_trip_and_validation():
    sc = ServeConfig(arch="qwen3-30b-a3b", scheduler="layered",
                     rate=2.5, requests=16, batch_fraction=0.25,
                     pages=64, preemption="swap", spec="ngram",
                     http=":8000", ratelimit_rate=4.0,
                     prompt_len=(8, 32)).validate()
    sc2 = ServeConfig.from_json(sc.to_json())
    assert sc2 == sc
    assert sc2.http_endpoint() == ("127.0.0.1", 8000)
    enabled, mode = sc2.preemption_opts()
    assert enabled and mode == "swap"
    ek, sk = sc2.engine_kwargs(), sc2.sim_kwargs()
    assert ek["preemption_mode"] == sk["preemption_mode"] == "swap"
    assert ek["pages"] == sk["n_pages"] == 64
    assert sk["spec_mode"] == "ngram"
    assert ek["packed"] is True
    # the derived dicts are the JAX package's (engine: plus the port's
    # draft_config, which the JAX engine takes as draft_model)
    jsc = JaxServeConfig.from_json(json.dumps(
        {k: v for k, v in json.loads(sc.to_json()).items()
         if k not in PORT_ONLY}))
    assert sk == jsc.sim_kwargs()
    skw, jkw = sc2.server_kwargs(), jsc.server_kwargs()
    assert dataclasses.astuple(skw.pop("slo")) \
        == dataclasses.astuple(jkw.pop("slo"))
    assert skw == jkw

    for bad in (dict(scheduler="nope"), dict(rate=0.0),
                dict(batch_fraction=1.5), dict(preemption="maybe"),
                dict(http="not-an-endpoint"),
                dict(spec="draft"),            # draft needs draft_config
                dict(simulate=True, http=":1"),
                dict(disagg=True, http=":1"),
                dict(pool_watermark=2.0), dict(spec_acceptance=0.0),
                dict(hw="tpu"), dict(dataset="nope")):
        with pytest.raises(ValueError):
            ServeConfig(**bad).validate()
    with pytest.raises(ValueError):
        ServeConfig.from_json('{"no_such_field": 1}')


def _flags(cls) -> set:
    ap = argparse.ArgumentParser()
    cls.add_arguments(ap)
    return {o for a in ap._actions for o in a.option_strings} - {"-h",
                                                                 "--help"}


def test_serve_config_argparse_matches_fields():
    """Every field is settable from the CLI, and the port's fields and
    flags are the JAX package's plus its own four."""
    ap = argparse.ArgumentParser()
    ServeConfig.add_arguments(ap)
    args = ap.parse_args([
        "--smoke", "--scheduler", "layered", "--requests", "9",
        "--preemption", "swap", "--no-prefix-cache",
        "--http", ":0", "--ratelimit-rate", "3",
        "--queue-watermark", "7", "--pool-watermark", "0.5",
        "--no-packed", "--prompt-len", "8", "40"])
    sc = ServeConfig.from_args(args)
    assert (sc.smoke, sc.requests, sc.preemption) == (True, 9, "swap")
    assert not sc.prefix_cache and not sc.packed
    assert (sc.queue_watermark, sc.pool_watermark) == (7, 0.5)
    assert sc.prompt_len == (8, 40)
    missing = {f.name for f in dataclasses.fields(ServeConfig)} \
        - set(vars(args))
    assert not missing, missing

    port = {f.name for f in dataclasses.fields(ServeConfig)}
    jax_ = {f.name for f in dataclasses.fields(JaxServeConfig)}
    assert port == jax_ | PORT_ONLY
    assert _flags(ServeConfig) == _flags(JaxServeConfig) | {
        "--dtype", "--device", "--prompt-len", "--new-tokens"}


# ------------------------------------------------------------ load_gen CLI


def test_load_gen_in_process_verifies(capsys):
    """``load_gen``'s in-process run over the served weights: every
    request 200, the admission-log replay identical, the offline replay
    bit-identical ("verified"), exit code 0."""
    sc = dataclasses.replace(BASE, smoke=True, requests=8, http=None)
    args = argparse.Namespace(url=None, clients=4, verify=True, out=None,
                              vocab_size=1024)
    tm, tp = _weights()
    assert asyncio.run(load_gen._amain(sc, args, tm, tp)) == 0
    out = capsys.readouterr().out
    assert "8/8 ok" in out and "verified" in out
    assert "8/8 streams bit-identical" in out


def test_engine_outputs_are_host_ints():
    """The done summary and /metrics read ``engine.outputs``: Python ints,
    never tensors (a tensor there would sync the card per read)."""
    eng = _make_engine()
    for p in ([1, 2, 3, 4], [5, 6, 7]):
        eng.submit(p, 4)
    eng.run()
    assert all(type(t) is int for toks in eng.outputs.values()
               for t in toks)
    assert not any(isinstance(v, torch.Tensor)
                   for v in vars(eng.alloc).values())


def test_launcher_serves_http():
    """``python -m repro_torch.launch.serve --http :0`` on the CPU: the
    process binds an OS-assigned port, answers a streamed generation and
    /healthz, and stops on SIGINT."""
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--http", ":0", "--slots", "4", "--max-len",
         "64"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    watchdog = threading.Timer(120.0, proc.kill)   # a hung start fails
    watchdog.start()
    try:
        line = proc.stdout.readline()
        while line and "listening" not in line:
            line = proc.stdout.readline()
        host, port = re.search(r"http://([\d.]+):(\d+)", line).groups()

        async def go():
            status, _, events = await _post_generate(
                host, int(port), {"prompt_tokens": [1, 2, 3, 4],
                                  "max_new_tokens": 5})
            return status, events, await _fetch(host, int(port), "/healthz")
        status, events, (health, _) = asyncio.run(go())
        assert status == 200 and health == 200
        assert len([d for k, d in events if k == "token"]) == 5
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        watchdog.cancel()
    assert "shutting down" in out
