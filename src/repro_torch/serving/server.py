"""Async HTTP/SSE serving front-end — the port's copy of the JAX
package's ``serving/server.py`` (DESIGN.md §Serving front-end).

The piece that turns trace replay into an actual service: a hand-rolled
asyncio HTTP/1.1 server (stdlib only — no web framework) ingesting
requests CONCURRENTLY with the engine iteration loop and streaming tokens
back as they are generated.

Threading / clock model
-----------------------
Two threads, one bridge:

  * The ENGINE thread runs the unmodified ``ServingRuntime`` loop in
    wall-clock mode (``EngineExecutor(wall=True)``) fed by a
    ``SubmitQueue`` — exactly the open-loop replay path, with the trace
    replaced by live arrivals.  All torch execution, scheduling and token
    timestamping happen here; the serving loop never blocks on a socket.
    torch keeps the current CUDA device and stream per thread: the thread
    binds the engine's device before it runs the loop, so every launch,
    copy and the iteration's one sync sit on that device's default
    stream, the stream the engine was built on.
  * The ASYNCIO thread owns every connection.  POST handlers validate,
    rate-limit, backpressure-check, then ``SubmitQueue.put`` the frozen
    ``SubmitSpec``; the ticket's ``on_submit`` hook (which fires in the
    engine thread strictly before the request's first token) registers
    the response's token stream, so an SSE event can never race past an
    unregistered stream.  Tokens cross back via
    ``loop.call_soon_threadsafe`` onto per-request asyncio queues.
    Nothing on this thread reads a tensor: the handlers read the engine's
    host state only (its ``requests``, ``outputs`` of Python ints, the
    scheduler's queue and the page allocator), so no handler synchronizes
    the card from the wrong thread.

Endpoints
---------
  * ``POST /v1/generate`` — body ``{"prompt_tokens": [...],
    "max_new_tokens": N, "slo_class": "interactive", "tenant": "...",
    "stream": true}``.  With ``stream`` (default) the response is
    ``text/event-stream``: one ``token`` event per generated token in
    emission order, then one ``done`` event carrying the full token list
    and timing summary.  Without it, one JSON document at completion.
  * ``GET /metrics`` — Prometheus text exposition
    (``metrics.prometheus_text``): TTFT/TBT percentiles, per-class SLO
    attainment, prefix hit rate, preemption/swap/queue/pool/HTTP
    counters.
  * ``GET /healthz`` — liveness (503 once the engine thread has died).
  * ``GET /readyz`` — readiness: 503 while draining, while the
    degradation ladder's top rung is refusing interactive work, or once
    the engine is dead; load balancers should route on this, not
    healthz.

Backpressure
------------
Admission control answers 429 + ``Retry-After`` from two independent
gates, checked BEFORE the spec enters the queue: a per-tenant token
bucket (``serving/ratelimit.py``), and a load watermark — queue depth
(scheduler waiting + feed backlog) at or above ``queue_watermark`` while
the paged-KV pool's free fraction is at or below ``pool_watermark``.
Deep queue alone means the scheduler is draining fine; empty pool alone
means admission is about to queue briefly; both together mean real
oversubscription, and accepting more work would only grow TTFT tails.

Admission log
-------------
``admission_log`` records, from the engine thread, the engine iteration at
which each live request entered the scheduler, with its spec: replaying
those specs on the iteration clock with those iterations as arrival times
reproduces the live run's plans exactly (``launch/load_gen.py``
``replay_admissions``), which is how a live bf16 run on the card is held
bit for bit against an offline one (other cohorts give other GEMM shapes,
and bf16 rounding then moves argmaxes).
"""

from __future__ import annotations

import asyncio
import json
import math
import threading
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.plan import RequestState, SubmitSpec
from repro_torch.serving.metrics import SLOConfig, fault_counters, prometheus_text
from repro_torch.serving.ratelimit import TenantRateLimiter
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime, SubmitQueue

_SSE_HEADERS = (b"Content-Type: text/event-stream\r\n"
                b"Cache-Control: no-cache\r\n")


class _TokenStream:
    """Engine-thread producer -> asyncio-consumer bridge for one request's
    token events.  Items: ("token", id, t) | ("done", summary)."""

    def __init__(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop
        self.queue: asyncio.Queue = asyncio.Queue()

    def push(self, item) -> None:
        self._loop.call_soon_threadsafe(self.queue.put_nowait, item)


class ServingServer:
    """The HTTP/SSE front-end over one live ``Engine``.

    ``ratelimit_rate``/``ratelimit_burst`` configure the per-tenant token
    bucket (None rate disables rate limiting); ``queue_watermark`` /
    ``pool_watermark`` the overload gate; ``slo`` an optional SLOConfig
    for live attainment in /metrics; ``record_plans`` keeps the runtime's
    plan stream (``runtime.plans``) for the admission-log replay.
    ``start``/``stop`` are coroutines (embed in an existing loop — the load
    generator does); ``serve_forever`` is the blocking CLI entry."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 8000,
                 ratelimit_rate: Optional[float] = None,
                 ratelimit_burst: float = 8.0,
                 queue_watermark: int = 64,
                 pool_watermark: float = 0.125,
                 retry_after: float = 1.0,
                 slo: Optional[SLOConfig] = None,
                 keepalive_timeout: float = 5.0,
                 max_iterations: int = 1_000_000_000,
                 faults=None, retry_budget: int = 3,
                 deadline_ms: Optional[float] = None,
                 drain_timeout: float = 10.0,
                 record_plans: bool = False):
        self.engine = engine
        self.host = host
        self.port = port
        self.slo = slo
        self.queue_watermark = queue_watermark
        self.pool_watermark = pool_watermark
        self.retry_after = retry_after
        self.keepalive_timeout = keepalive_timeout
        self.max_iterations = max_iterations
        # default per-request completion deadline (wall ms) applied to
        # specs that do not carry their own; None disables shedding
        self.deadline_ms = deadline_ms
        self.drain_timeout = drain_timeout
        self.limiter = None if ratelimit_rate is None else \
            TenantRateLimiter(ratelimit_rate, ratelimit_burst)

        # the engine's CUDA device with its index (None on the CPU): the
        # engine thread binds it, since torch keeps the device per thread
        dev = getattr(engine, "device", None)
        self._cuda_device = None
        if dev is not None and dev.type == "cuda":
            self._cuda_device = dev if dev.index is not None else \
                torch.device("cuda", torch.cuda.current_device())

        self.feed = SubmitQueue()
        self.executor = EngineExecutor(engine, wall=True)
        self.runtime = ServingRuntime(self.executor,
                                      on_token=self._on_token,
                                      clock="executor",
                                      faults=faults,
                                      retry_budget=retry_budget,
                                      on_shed=self._on_shed,
                                      record_plans=record_plans)
        self._thread: Optional[threading.Thread] = None
        self._engine_error: Optional[BaseException] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

        # engine-thread-only token bookkeeping (streams registered by
        # on_submit hooks, also engine thread — no lock needed there)
        self._streams: Dict[int, _TokenStream] = {}
        self._emitted: Dict[int, int] = {}
        # the ground-truth emission order, kept for the SSE-ordering tests
        # and the load generator's offline-replay verification
        self.token_log: List[Tuple[int, int]] = []
        # (req_id, engine iteration at submission, spec), engine thread
        self.admission_log: List[Tuple[int, int, SubmitSpec]] = []
        # asyncio-thread counters for /metrics
        self._status_counts: Dict[int, int] = {}
        self.n_dropped_streams = 0
        self.n_streams_completed = 0
        self.n_shed_streams = 0
        self._draining = False

    # ------------------------------------------------------------ lifecycle

    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._thread = threading.Thread(target=self._drive,
                                        name="serving-loop", daemon=True)
        self._thread.start()
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def drain(self, timeout: Optional[float] = None) -> None:
        """Graceful shutdown: flip to draining (new POSTs answer 503 and
        /readyz fails so balancers stop routing here), wait up to
        ``drain_timeout`` seconds for in-flight streams to finish, cancel
        any stragglers (the engine thread sheds them, freeing their KV
        and terminating their SSE streams), then stop the engine and the
        listener."""
        self._draining = True
        t = self.drain_timeout if timeout is None else timeout
        loop = asyncio.get_running_loop()
        deadline = loop.time() + t
        while self._streams and self._thread.is_alive() \
                and loop.time() < deadline:
            await asyncio.sleep(0.05)
        for rid in list(self._streams):
            self.runtime.cancel(rid)
        await self.stop()

    async def stop(self) -> None:
        """Close ingestion, drain resident work, join the engine thread,
        then tear the listener down."""
        self.feed.close()
        if self._thread is not None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._thread.join)
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        if self._engine_error is not None:
            raise self._engine_error

    def serve_forever(self) -> None:
        async def _main():
            await self.start()
            print(f"[server] listening on http://{self.host}:{self.port} "
                  f"(POST /v1/generate, GET /metrics)")
            try:
                while self._thread.is_alive():
                    await asyncio.sleep(0.5)
                if self._engine_error is not None:
                    raise self._engine_error
            finally:
                await self.stop()
        try:
            asyncio.run(_main())
        except KeyboardInterrupt:
            print("[server] shutting down")

    def _drive(self) -> None:
        try:
            if self._cuda_device is not None:
                torch.cuda.set_device(self._cuda_device)
            self.result = self.runtime.run(
                feed=self.feed, max_iterations=self.max_iterations)
        except BaseException as e:                  # surfaced by /healthz
            self._engine_error = e
            self.feed.close()

    # ----------------------------------------------------- engine callbacks

    def _on_token(self, rid: int, tok: Optional[int], t: float) -> None:
        """Engine thread: one call per emitted token, in emission order."""
        self.token_log.append((rid, tok))
        stream = self._streams.get(rid)
        if stream is None:
            return
        stream.push(("token", tok, t))
        req = self.engine.requests[rid]
        n = self._emitted[rid] = self._emitted.get(rid, 0) + 1
        # a speculative iteration can commit several tokens after the
        # scheduler already marked the request DONE — the stream ends only
        # once every generated token has been pushed
        if req.state is RequestState.DONE and n >= req.n_generated:
            stream.push(("done", {
                "req_id": rid,
                "n_generated": req.n_generated,
                "tokens": list(self.engine.outputs[rid]),
                "ttft": req.ttft(),
                "finish_time": req.finish_time,
                "n_preemptions": req.n_preemptions,
                "n_swaps": req.n_swaps,
            }))
            self._streams.pop(rid, None)
            self._emitted.pop(rid, None)

    def _on_shed(self, req, reason: str) -> None:
        """Engine thread: the runtime removed ``req`` without completing
        it (deadline expiry, retry exhaustion, cancel, degradation).  Its
        KV is already freed; deregister the stream here — the same thread
        that registered it — and emit the terminal event so the
        connection's consumer unblocks with the partial result."""
        rid = req.req_id
        stream = self._streams.pop(rid, None)
        self._emitted.pop(rid, None)
        self.n_shed_streams += 1
        if stream is None:
            return
        stream.push(("done", {
            "req_id": rid,
            "n_generated": req.n_generated,
            "tokens": list(self.engine.outputs.get(rid, [])),
            "ttft": req.ttft(),
            "finish_time": req.finish_time,
            "n_preemptions": req.n_preemptions,
            "n_swaps": req.n_swaps,
            "shed_reason": reason,
        }))

    # ------------------------------------------------------------- overload

    def queue_depth(self) -> int:
        return len(self.engine.scheduler.waiting) + self.feed.backlog

    def overloaded(self) -> Optional[float]:
        """Retry-after seconds when BOTH watermarks are breached, else
        None.  Reads engine state cross-thread — int/len reads are atomic
        enough for an admission heuristic."""
        depth = self.queue_depth()
        if depth < self.queue_watermark:
            return None
        alloc = self.engine.alloc
        free_frac = alloc.n_free_pages / max(alloc.n_pages, 1)
        if free_frac > self.pool_watermark:
            return None
        return min(30.0, self.retry_after *
                   max(1.0, depth / max(self.queue_watermark, 1)))

    # ------------------------------------------------------------- HTTP

    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        """Serve requests off one connection.  Non-SSE requests honour
        ``Connection: keep-alive``: the handler loops, waiting up to
        ``keepalive_timeout`` seconds for the next request before closing
        the idle socket.  SSE responses always close — the event stream
        owns the connection until the generation finishes."""
        try:
            while True:
                try:
                    req = await asyncio.wait_for(
                        self._read_request(reader),
                        timeout=self.keepalive_timeout)
                except asyncio.TimeoutError:
                    break                        # idle keep-alive expired
                if req is None:
                    break
                method, path, headers, body = req
                keep = headers.get("connection", "").lower() == "keep-alive"
                if method == "POST" and path == "/v1/generate":
                    keep = await self._generate(writer, body, keep=keep)
                elif method == "GET" and path == "/metrics":
                    await self._metrics(writer, keep=keep)
                elif method == "GET" and path == "/healthz":
                    if self._engine_error is not None \
                            or not self._thread.is_alive():
                        await self._respond(writer, 503, {
                            "status": "engine dead",
                            "error": repr(self._engine_error)}, keep=keep)
                    else:
                        await self._respond(writer, 200, {"status": "ok"},
                                            keep=keep)
                elif method == "GET" and path == "/readyz":
                    dead = self._engine_error is not None \
                        or not self._thread.is_alive()
                    if dead or self._draining \
                            or self.runtime.ladder.refuse_new:
                        reason = "engine dead" if dead else (
                            "draining" if self._draining else "degraded")
                        await self._respond(
                            writer, 503,
                            {"ready": False, "reason": reason,
                             "degradation": self.runtime.ladder.level},
                            keep=keep)
                    else:
                        await self._respond(writer, 200, {"ready": True},
                                            keep=keep)
                else:
                    await self._respond(
                        writer, 404,
                        {"error": f"no route {method} {path}"}, keep=keep)
                if not keep:
                    break
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError, OSError):
                pass

    @staticmethod
    async def _read_request(reader: asyncio.StreamReader):
        line = await reader.readline()
        if not line or line in (b"\r\n", b"\n"):
            return None
        try:
            method, path, _ = line.decode("latin-1").split(" ", 2)
        except ValueError:
            return None
        headers: Dict[str, str] = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            k, _, v = h.decode("latin-1").partition(":")
            headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", "0") or 0)
        body = await reader.readexactly(n) if n else b""
        return method, path.split("?", 1)[0], headers, body

    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                429: "Too Many Requests", 500: "Internal Server Error",
                503: "Service Unavailable"}

    def _head(self, status: int, extra: bytes = b"",
              keep: bool = False) -> bytes:
        self._status_counts[status] = self._status_counts.get(status, 0) + 1
        reason = self._REASONS.get(status, "Unknown")
        conn = b"Connection: keep-alive\r\n" if keep \
            else b"Connection: close\r\n"
        return f"HTTP/1.1 {status} {reason}\r\n".encode() + conn + extra

    async def _respond(self, writer, status: int, payload,
                       retry_after: Optional[float] = None,
                       ctype: str = "application/json",
                       keep: bool = False) -> None:
        body = payload if isinstance(payload, bytes) \
            else json.dumps(payload).encode()
        extra = f"Content-Type: {ctype}\r\nContent-Length: {len(body)}\r\n"
        if retry_after is not None:
            extra += f"Retry-After: {max(1, math.ceil(retry_after))}\r\n"
        writer.write(self._head(status, extra.encode(), keep=keep)
                     + b"\r\n" + body)
        await writer.drain()

    async def _metrics(self, writer, keep: bool = False) -> None:
        alloc = self.engine.alloc
        counters = {
            "queue_depth": float(self.queue_depth()),
            "kv_pages_used": float(alloc.pages_in_use()),
            "kv_pages_total": float(alloc.n_pages),
            "active_streams": float(len(self._streams)),
            "dropped_streams_total": float(self.n_dropped_streams),
            "streams_completed_total": float(self.n_streams_completed),
            "engine_iterations_total": float(self.engine.iteration),
            "engine_dispatches_total": float(self.engine.n_dispatches),
            "engine_preempted_total": float(self.engine.n_preempted),
            "engine_swapped_out_total": float(self.engine.n_swapped_out),
            "shed_streams_total": float(self.n_shed_streams),
        }
        counters.update(fault_counters(**self.runtime.fault_stats()))
        labeled = {"http_responses_total|status":
                   {str(s): float(c)
                    for s, c in sorted(self._status_counts.items())}}
        if self.limiter is not None:
            rl = self.limiter.counters()
            labeled["ratelimit_granted_total|tenant"] = \
                {t: c["granted"] for t, c in rl.items()}
            labeled["ratelimit_rejected_total|tenant"] = \
                {t: c["rejected"] for t, c in rl.items()}
        text = prometheus_text(list(self.engine.requests.values()),
                               slo=self.slo, counters=counters,
                               labeled=labeled)
        await self._respond(writer, 200, text.encode(),
                            ctype="text/plain; version=0.0.4", keep=keep)

    async def _generate(self, writer, body: bytes,
                        keep: bool = False) -> bool:
        """Returns whether the connection may be kept open for another
        request (never after an SSE stream — it owns the socket)."""
        try:
            payload = json.loads(body or b"{}")
            dl = payload.get("deadline_ms", self.deadline_ms)
            spec = SubmitSpec(
                max_new_tokens=int(payload["max_new_tokens"]),
                prompt_tokens=tuple(int(t)
                                    for t in payload["prompt_tokens"]),
                slo_class=str(payload.get("slo_class", "interactive")),
                tenant=payload.get("tenant"),
                prefix_cache=bool(payload.get("prefix_cache", True)),
                speculative=bool(payload.get("speculative", True)),
                deadline_ms=None if dl is None else float(dl))
        except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
            await self._respond(writer, 400, {"error": f"bad request: {e}"},
                                keep=keep)
            return keep
        if self._engine_error is not None or not self._thread.is_alive():
            await self._respond(writer, 503, {"error": "engine dead"},
                                keep=keep)
            return keep
        if self._draining:
            await self._respond(writer, 503, {"error": "draining"},
                                retry_after=self.retry_after, keep=keep)
            return keep
        if self.runtime.ladder.refuse_new \
                and spec.slo_class == "interactive":
            # top degradation rung: interactive admission is the shed class
            await self._respond(
                writer, 503,
                {"error": "degraded: interactive load shed",
                 "degradation": self.runtime.ladder.level},
                retry_after=self.retry_after, keep=keep)
            return keep
        if self.limiter is not None:
            wait = self.limiter.acquire(spec.tenant)
            if wait > 0:
                await self._respond(
                    writer, 429, {"error": "rate limited",
                                  "tenant": spec.tenant,
                                  "retry_after": wait},
                    retry_after=wait, keep=keep)
                return keep
        wait = self.overloaded()
        if wait is not None:
            await self._respond(
                writer, 429, {"error": "overloaded",
                              "queue_depth": self.queue_depth(),
                              "retry_after": wait},
                retry_after=wait, keep=keep)
            return keep

        stream = _TokenStream(self._loop)
        submitted = self._loop.create_future()

        def on_submit(req):                       # engine thread, pre-token
            self._streams[req.req_id] = stream
            self.admission_log.append((req.req_id, self.engine.iteration,
                                       spec))
            self._loop.call_soon_threadsafe(
                submitted.set_result, req.req_id)

        def on_fail(exc):                         # engine thread
            self._loop.call_soon_threadsafe(_fail_safely, exc)

        def _fail_safely(exc):
            if not submitted.done():
                submitted.set_exception(exc)

        try:
            self.feed.put(spec, on_submit=on_submit, on_fail=on_fail)
        except RuntimeError:                      # queue closed: shutdown
            await self._respond(writer, 503, {"error": "shutting down"},
                                keep=keep)
            return keep
        try:
            rid = await submitted
        except ValueError as e:                   # engine rejected the spec
            await self._respond(writer, 400, {"error": str(e)}, keep=keep)
            return keep
        except Exception as e:
            await self._respond(writer, 500, {"error": repr(e)}, keep=keep)
            return keep

        if payload.get("stream", True):
            await self._stream_sse(writer, rid, stream,
                                   tag=payload.get("tag"))
            return False
        await self._block_json(writer, rid, stream,
                               tag=payload.get("tag"), keep=keep)
        return keep

    async def _stream_sse(self, writer, rid: int, stream: _TokenStream,
                          tag=None) -> None:
        writer.write(self._head(200, _SSE_HEADERS) + b"\r\n")
        try:
            await writer.drain()
            index = 0
            while True:
                item = await stream.queue.get()
                if item[0] == "token":
                    _, tok, t = item
                    data = json.dumps({"req_id": rid, "index": index,
                                       "token": tok, "t": t})
                    writer.write(f"event: token\ndata: {data}\n\n".encode())
                    await writer.drain()
                    index += 1
                else:
                    summary = dict(item[1], tag=tag)
                    data = json.dumps(summary)
                    writer.write(f"event: done\ndata: {data}\n\n".encode())
                    await writer.drain()
                    self.n_streams_completed += 1
                    return
        except (ConnectionResetError, BrokenPipeError, OSError):
            # client went away mid-stream: cancel the generation — the
            # engine thread sheds the request at the next iteration
            # boundary, freeing its KV and deregistering this stream
            self.n_dropped_streams += 1
            self.runtime.cancel(rid)

    async def _block_json(self, writer, rid: int, stream: _TokenStream,
                          tag=None, keep: bool = False) -> None:
        tokens: List[int] = []
        while True:
            item = await stream.queue.get()
            if item[0] == "token":
                tokens.append(item[1])
            else:
                summary = dict(item[1], tag=tag)
                await self._respond(writer, 200, summary, keep=keep)
                self.n_streams_completed += 1
                return
