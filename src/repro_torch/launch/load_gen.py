"""Closed-loop load generator for the port's HTTP/SSE front-end
(serving/server.py) — and the acceptance harness proving the live server
returns EXACTLY the tokens an offline replay would.  The port's copy of
the JAX package's ``launch/load_gen.py``.

``--clients N`` concurrent clients pull requests off one shared trace
(built by the SAME ``ServeConfig.engine_trace`` generator serve.py
replays), POST them to ``/v1/generate``, parse the SSE stream, honor 429
``Retry-After`` backoff, and record client-side latency.  With no
``--url`` the generator boots an IN-PROCESS server on an OS-assigned port
from the same ServeConfig, over the weights that ``--seed`` draws.

Verification (``--verify``, default in in-process mode): after the load
run, a FRESH engine over the SAME weights (the served model and params:
a full-size model has room for one copy on the card) replays the same
trace through the offline ``ServingRuntime`` under the iteration clock,
and every request's live token stream must be bit-identical to its
offline twin.  Greedy token identity is scheduling-invariant in fp32, so
this holds even though the live server admits requests in wall-clock
arrival order under whatever interleaving the OS produced — any mismatch
means the serving path corrupted state, and the generator exits nonzero.
In bf16 on the card it need not hold: the live cohorts give other GEMM
shapes, and rounding can flip an argmax at a near-tie (run with
``--no-verify`` there).

In-process runs are also held against a replay of the server's own
admission log (``replay_admissions``): the same specs, each arriving at
the engine iteration at which it entered the live scheduler, through a
fresh engine on the same weights, on the iteration clock.  That replay
reproduces the live run's plans, so its streams are the live streams bit
for bit in any dtype (the kernels are deterministic).

Usage:
  # in-process on the CPU: 4 clients, 8 requests, verify token identity
  PYTHONPATH=src python -m repro_torch.launch.load_gen --smoke \
      --device cpu --clients 4 --requests 8

  # against a running server (launched with serve.py --http :8000)
  PYTHONPATH=src python -m repro_torch.launch.load_gen --smoke \
      --url http://127.0.0.1:8000 --clients 16 --requests 200 --no-verify
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from repro_torch.launch.config import ServeConfig
from repro_torch.serving.metrics import percentile


@dataclass
class ClientResult:
    index: int                      # position in the trace
    tokens: List[int] = field(default_factory=list)
    latency: float = 0.0            # POST to done event, client wall clock
    ttfb: float = 0.0               # POST to first token event
    n_retries: int = 0
    status: int = 0


@dataclass
class LoadReport:
    results: List[ClientResult]
    elapsed: float
    n_429: int
    n_errors: int

    def summary(self) -> Dict[str, float]:
        ok = [r for r in self.results if r.status == 200]
        lat = [r.latency for r in ok]
        ttfb = [r.ttfb for r in ok]
        return {
            "n_requests": float(len(self.results)),
            "n_ok": float(len(ok)),
            "n_429_retries": float(self.n_429),
            "n_errors": float(self.n_errors),
            "elapsed_s": self.elapsed,
            "throughput_rps": len(ok) / self.elapsed if self.elapsed
            else 0.0,
            "latency_p50": percentile(lat, 50),
            "latency_p99": percentile(lat, 99),
            "ttfb_p50": percentile(ttfb, 50),
            "ttfb_p99": percentile(ttfb, 99),
        }


async def _post_generate(host: str, port: int, payload: dict,
                         timeout: float = 300.0,
                         on_first_byte=None) -> Tuple[int, dict, list]:
    """One POST /v1/generate over a fresh connection (the server always
    answers Connection: close).  Returns (status, headers, sse_events);
    non-SSE bodies come back as one synthetic ("json", payload) event.
    ``on_first_byte`` fires when the first body chunk past the headers
    lands — the client-side time-to-first-byte mark."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        body = json.dumps(payload).encode()
        writer.write((f"POST /v1/generate HTTP/1.1\r\nHost: {host}\r\n"
                      f"Content-Type: application/json\r\n"
                      f"Content-Length: {len(body)}\r\n\r\n").encode()
                     + body)
        await writer.drain()
        raw = await asyncio.wait_for(
            reader.readuntil(b"\r\n\r\n"), timeout)
        first = await asyncio.wait_for(reader.read(4096), timeout)
        if first and on_first_byte is not None:
            on_first_byte()
        raw += first
        while first:
            first = await asyncio.wait_for(reader.read(1 << 16), timeout)
            raw += first
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ", 2)[1])
    headers = {}
    for ln in lines[1:]:
        k, _, v = ln.partition(":")
        headers[k.strip().lower()] = v.strip()
    if "text/event-stream" in headers.get("content-type", ""):
        events = []
        for block in rest.decode().strip().split("\n\n"):
            ev: Dict[str, str] = {}
            for ln in block.split("\n"):
                k, _, v = ln.partition(": ")
                ev[k] = v
            if "event" in ev:
                events.append((ev["event"], json.loads(ev["data"])))
        return status, headers, events
    payload = json.loads(rest) if rest else {}
    return status, headers, [("json", payload)]


async def _fetch(host: str, port: int, path: str) -> Tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\n\r\n"
                     .encode())
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
        try:
            await writer.wait_closed()
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), body


async def run_load(host: str, port: int, trace, n_clients: int,
                   max_retries: int = 100) -> LoadReport:
    """Closed loop: ``n_clients`` workers drain the shared trace; each
    request retries on 429 after the server's Retry-After."""
    work = list(enumerate(trace))
    queue: asyncio.Queue = asyncio.Queue()
    for item in work:
        queue.put_nowait(item)
    results: List[ClientResult] = []
    n_429 = 0
    n_errors = 0
    t0 = time.monotonic()

    async def worker():
        nonlocal n_429, n_errors
        while True:
            try:
                index, tr = queue.get_nowait()
            except asyncio.QueueEmpty:
                return
            res = ClientResult(index=index)
            payload = {
                "prompt_tokens": list(tr.prompt_tokens),
                "max_new_tokens": tr.output_len,
                "slo_class": tr.slo_class,
                "tag": index,
            }
            for _ in range(max_retries):
                t_post = time.monotonic()

                def mark_ttfb():
                    res.ttfb = time.monotonic() - t_post
                try:
                    status, headers, events = await _post_generate(
                        host, port, payload, on_first_byte=mark_ttfb)
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    n_errors += 1
                    res.status = -1
                    break
                if status == 429:
                    n_429 += 1
                    res.n_retries += 1
                    await asyncio.sleep(
                        float(headers.get("retry-after", 1)))
                    continue
                res.status = status
                if status != 200:
                    n_errors += 1
                    break
                for kind, data in events:
                    if kind == "token":
                        res.tokens.append(data["token"])
                    elif kind == "done":
                        res.latency = time.monotonic() - t_post
                        assert res.tokens == data["tokens"], \
                            (index, res.tokens, data["tokens"])
                break
            else:
                n_errors += 1
                res.status = 429
            results.append(res)

    await asyncio.gather(*[worker() for _ in range(n_clients)])
    return LoadReport(results=results, elapsed=time.monotonic() - t0,
                      n_429=n_429, n_errors=n_errors)


def offline_tokens(sc: ServeConfig, trace, model=None,
                   params=None) -> List[List[int]]:
    """The ground truth: a fresh engine (over ``model``/``params`` when
    given, else identically seeded ones) replays the same trace through
    the offline runtime (iteration clock, no HTTP, no threads); returns
    per-trace-index token lists."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.runtime import EngineExecutor, ServingRuntime

    eng = build_engine(sc, model, params)
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration")
    res = rt.run(trace, max_iterations=1_000_000)
    return [list(eng.outputs[r.req_id]) for r in res.requests]


def plan_key(plan) -> tuple:
    """An IterationPlan as a plain value that compares with ``==``."""
    return (tuple(plan.admitted_ids), tuple(plan.preempted_ids),
            tuple(plan.swapped_out_ids), tuple(plan.swapped_in_ids),
            tuple(plan.decode_ids),
            tuple((s.req_id, s.token_start, s.token_end, s.block_start,
                   s.block_end, s.emits_first_token) for s in plan.prefill))


def replay_admissions(sc: ServeConfig, admission_log, model=None,
                      params=None) -> Dict:
    """Replay a live server's ``admission_log`` — (req_id, engine
    iteration at submission, spec) — through a fresh engine over
    ``model``/``params`` on the iteration clock, each spec arriving at its
    iteration: the live run's admissions at the live run's iteration
    boundaries.  Returns the replay's ``plans`` (``plan_key`` values) and
    ``outputs`` by request id (the live ids: specs go in submission
    order)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.serving.runtime import EngineExecutor, ServingRuntime

    eng = build_engine(sc, model, params)
    trace = [dataclasses.replace(spec, arrival_time=float(it))
             for _, it, spec in sorted(admission_log, key=lambda e: e[0])]
    rt = ServingRuntime(EngineExecutor(eng), clock="iteration",
                        record_plans=True)
    rt.run(trace, max_iterations=1_000_000)
    return {"plans": [plan_key(p) for p in rt.plans],
            "outputs": {rid: list(t) for rid, t in eng.outputs.items()}}


def check_admission_replay(plans, outputs, replay: Dict) -> int:
    """Hold a live server's plan stream (``plan_key`` values) and token
    streams (by request id) against ``replay`` (``replay_admissions`` of
    its log); returns the number of parted streams, raising if the plans
    differ (then the replay proves nothing)."""
    if plans != replay["plans"]:
        first = next((i for i, (x, y) in enumerate(zip(plans, replay["plans"]))
                      if x != y), min(len(plans), len(replay["plans"])))
        raise AssertionError(
            f"admission-log replay planned otherwise: {len(plans)} live "
            f"plans, {len(replay['plans'])} replayed; first difference at "
            f"plan {first}")
    bad = 0
    for rid, toks in outputs.items():
        if list(toks) != replay["outputs"].get(rid):
            bad += 1
            print(f"[load-gen] REPLAY MISMATCH req={rid}: live={list(toks)} "
                  f"replay={replay['outputs'].get(rid)}", file=sys.stderr)
    return bad


def verify_identity(report: LoadReport, offline: List[List[int]]) -> int:
    """Compare every live stream with its offline twin; returns the
    number of mismatched requests (0 = bit-identical)."""
    bad = 0
    for r in report.results:
        if r.status != 200:
            bad += 1
            continue
        if r.tokens != offline[r.index]:
            bad += 1
            print(f"[load-gen] MISMATCH index={r.index}: "
                  f"live={r.tokens} offline={offline[r.index]}",
                  file=sys.stderr)
    return bad


async def _amain(sc: ServeConfig, args, model=None, params=None) -> int:
    if args.url:
        host, _, port = args.url.rstrip("/").rpartition("//")[-1] \
            .partition(":")
        host, port = host or "127.0.0.1", int(port or 80)
        server = None
        vocab = args.vocab_size
    else:
        from repro_torch.launch.serve import build_model, build_server
        if model is None:
            model, params = build_model(sc)
        if sc.http is None:
            sc.http = ":0"            # in-process: OS-assigned port
        server = build_server(sc, model, params, record_plans=True)
        await server.start()
        host, port = server.host, server.port
        vocab = server.engine.cfg.vocab_size
        print(f"[load-gen] in-process server on {host}:{port}")

    trace = sc.engine_trace(vocab)
    print(f"[load-gen] {args.clients} clients x {len(trace)} requests "
          f"-> {host}:{port}")
    report = await run_load(host, port, trace, args.clients)

    status, metrics_body = await _fetch(host, port, "/metrics")
    if server is not None:
        await server.stop()
    s = report.summary()
    print(f"[load-gen] {s['n_ok']:.0f}/{s['n_requests']:.0f} ok in "
          f"{s['elapsed_s']:.1f}s ({s['throughput_rps']:.1f} req/s); "
          f"{s['n_429_retries']:.0f} rate-limit retries, "
          f"{s['n_errors']:.0f} errors")
    print(f"[load-gen] client latency p50={s['latency_p50']:.3f}s "
          f"p99={s['latency_p99']:.3f}s; "
          f"ttfb p50={s['ttfb_p50']:.3f}s p99={s['ttfb_p99']:.3f}s")
    flat: Dict[str, float] = {}
    if status == 200:
        for ln in metrics_body.decode().splitlines():
            if ln.startswith("#") or not ln.strip():
                continue
            name, _, val = ln.rpartition(" ")
            flat[name] = float(val)
    out = {"summary": s, "config": json.loads(sc.to_json()),
           "metrics_scrape_ok": status == 200, "metrics": flat}
    if server is not None:
        replay = replay_admissions(sc, server.admission_log, model, params)
        bad = check_admission_replay(
            [plan_key(p) for p in server.runtime.plans],
            server.engine.outputs, replay)
        out["n_replay_mismatched"] = bad
        print(f"[load-gen] admission-log replay: {len(replay['plans'])} "
              f"plans identical; {len(replay['outputs']) - bad}/"
              f"{len(replay['outputs'])} streams bit-identical")
        del server
    if args.verify:
        offline = offline_tokens(sc, trace, model, params)
        bad = verify_identity(report, offline)
        out["n_mismatched"] = bad
        if bad:
            print(f"[load-gen] FAIL: {bad} stream(s) diverged from "
                  f"offline replay", file=sys.stderr)
        else:
            print(f"[load-gen] verified: all {len(trace)} live token "
                  f"streams bit-identical to offline replay")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2, default=float)
        print(f"[load-gen] report -> {args.out}")
    if s["n_errors"] or out.get("n_mismatched") \
            or out.get("n_replay_mismatched"):
        return 1
    return 0


def main() -> None:
    ap = argparse.ArgumentParser()
    ServeConfig.add_arguments(ap)
    ap.add_argument("--clients", type=int, default=8,
                    help="concurrent closed-loop clients")
    ap.add_argument("--url", default=None,
                    help="target server (default: boot an in-process "
                         "server from this ServeConfig)")
    ap.add_argument("--vocab-size", type=int, default=1024,
                    help="token id range for generated prompts when "
                         "--url is remote (in-process mode reads the "
                         "engine's config)")
    ap.add_argument("--verify", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="replay the trace offline and require "
                         "bit-identical token streams (default: on "
                         "in-process, off against --url)")
    ap.add_argument("--out", default=None,
                    help="write the JSON report here")
    args = ap.parse_args()
    sc = ServeConfig.from_args(args)
    sc.slots = min(sc.slots, 8)
    if args.verify is None:
        args.verify = args.url is None
    sys.exit(asyncio.run(_amain(sc, args)))


if __name__ == "__main__":
    main()
