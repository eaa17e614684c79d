"""One run of one cell: build, warm up, measure a window, read the
metrics, check what was served.

The window is driven through the port's own ``ServingRuntime.run`` over
``EngineExecutor(wall=True)``, the objects ``launch/serve.py``'s
``run_engine`` builds, with the engine ``build_engine`` makes from a
``ServeConfig``.  It starts when the runtime re-anchors its clock and ends
at the first iteration boundary at or past ``seconds``: the ``on_token``
callback records every token event (request, time) and, once the last
event of the iteration that crosses ``seconds`` has been delivered,
raises to leave the loop.  Requests whose scheduled arrival fell inside
the window but which were not injected yet count with their wait.

Set-up before it: the weights (``weights.draw``), the engine, every
kernel built and loaded, then one request a slot submitted and served
until each has its first token and two decode steps have run
(``warm_up``; this warms every path the window takes: layered prefill
groups, the emitting group, the decode step).
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from bench import check as C
from bench import traffic as T
from bench import window as W
from bench import work

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WARM_DECODES = 2


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    return json.loads((BENCH / kind / f"{name}.json").read_text())


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def port(c: dict):
    return importlib.import_module(f"bench.port.{c['model_type']}")


def run_config(c: dict) -> dict:
    """The configuration ``c`` as the port runs it, its departures from
    the published settings applied (``bench/port``): what the port and
    the reference both run."""
    from bench import port as P
    return P.as_run(port(c), c)


def port_config(c: dict):
    return port(c).config(run_config(c))


def reference(c: dict):
    return importlib.import_module(f"bench.reference.{c['model_type']}")


class _Stop(Exception):
    pass


def serve_config(cell: dict):
    from repro_torch.launch.config import ServeConfig
    return ServeConfig(scheduler=cell["scheduler"], slots=cell["slots"],
                       max_len=cell["max_len"], quantum=cell["quantum"],
                       token_budget=cell["token_budget"],
                       prefix_cache=cell["prefix_cache"],
                       moe_dispatch=cell["moe_dispatch"], open_loop=True,
                       clock="wall")


def build(cell: dict, config: dict, seed: int, device):
    """(model, params) of a run: the port's model at the configuration
    and the benchmark's weights."""
    from repro_torch.models.model import DecoderModel
    from bench import weights
    model = DecoderModel(port_config(config), device=device)
    return model, weights.draw(model.param_shapes(), seed, device)


def engine(cell: dict, model, params):
    """The engine, with every kernel built (where the checkout has none
    built yet) and loaded; the seconds that took are logged apart."""
    from repro_torch.launch.serve import build_engine, prepare_kernels
    eng = build_engine(serve_config(cell), model, params)
    t0 = time.time()
    prepare_kernels(eng.device)
    log(f"kernels built and loaded in {time.time() - t0:.3f} s")
    return eng


def _spec(r: T.Req):
    from repro_torch.core.plan import SubmitSpec
    return SubmitSpec(max_new_tokens=r.max_new, prompt_tokens=r.prompt,
                      arrival_time=r.arrival)


def warm_up(eng, reqs, quantum: int) -> None:
    """Serve ``reqs`` until each has its first token and ``WARM_DECODES``
    more iterations have run.  Each is prefilled as a cohort of its own
    (the layered scheduler's ``merge_cohort`` is off while the warm-up
    runs, back on for the window): a cohort of every slot would gather
    every slot's row of every layer at once.  Each request's output is
    sized so that it has its drawn remainder (``Req.max_new``) left when
    the window starts: the tokens it serves before then are counted from
    the cohorts' layer groups, which run back to back."""
    from repro_torch.core.layer_groups import num_groups
    from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
    sched = eng.scheduler
    groups = [num_groups(len(r.prompt), eng.model.n_blocks, quantum)
              for r in reqs]
    starts = [sum(groups[:i]) for i in range(len(groups))]
    last = starts[-1] + groups[-1] - 1 + WARM_DECODES
    order = []
    for r, s, g in zip(reqs, starts, groups):
        served = last - (s + g - 1) + 1
        n = min(served + r.max_new, eng.max_len - len(r.prompt))
        order.append(eng.submit_spec(_spec(T.Req(0.0, r.prompt, n))).req_id)
    ids = set(order)
    firsts, after = set(), []

    def on_token(rid, tok, t):
        if rid in ids:
            firsts.add(rid)
        if firsts == ids:
            after.append(eng.iteration)
            if len(set(after)) > WARM_DECODES:
                raise _Stop
    merge = getattr(sched, "merge_cohort", None)
    if merge is not None:
        sched.merge_cohort = False
    try:
        ServingRuntime(EngineExecutor(eng, wall=True), clock="executor",
                       on_token=on_token).run((), max_iterations=1 << 30)
    except _Stop:
        pass
    finally:
        if merge is not None:
            sched.merge_cohort = merge
    _sync(eng.device)
    left = [eng.requests[i].max_new_tokens - len(eng.outputs[i])
            for i in order]
    log(f"warm-up: {eng.iteration} iterations; outputs left at the "
        f"window's start {left}, drawn {[r.max_new for r in reqs]}")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(eng, arrivals, seconds: float, *, recorder=None,
            profiler=None) -> dict:
    """The window: ``arrivals`` (Req, arrival in seconds from its start)
    replayed open loop until the first iteration boundary at or past
    ``seconds``; in the traced run, ``recorder``'s wrappers and
    ``profiler`` cover it whole."""
    from repro_torch.serving.runtime import EngineExecutor, ServingRuntime
    events, bounds = [], []
    at_bound = [0]

    def on_token(rid, tok, t):
        events.append((rid, t))
        if not bounds or bounds[-1] != t:
            bounds.append(t)
            at_bound[0] = 0
        at_bound[0] += 1
        if t >= seconds and at_bound[0] == len(eng._step_events):
            raise _Stop
    base, it0, bytes0 = eng._next_id, eng.iteration, eng.expert_load_bytes
    runtime = ServingRuntime(EngineExecutor(eng, wall=True),
                             clock="executor", on_token=on_token)
    trace = [_spec(r) for r in arrivals]
    ctx = profiler if profiler is not None else contextlib.nullcontext()
    if recorder is not None:
        recorder.install(eng)
    try:
        with ctx:
            with torch.profiler.record_function("bench.window"):
                try:
                    runtime.run(trace, max_iterations=1 << 30)
                except _Stop:
                    pass
                _sync(eng.device)
    finally:
        if recorder is not None:
            recorder.remove()
    end = bounds[-1] if bounds else seconds
    ids = {base + i: r.arrival for i, r in enumerate(arrivals)}
    return {"events": events, "bounds": bounds, "end": end,
            "arrivals": ids,
            "iterations": eng.iteration - it0,
            "expert_bytes": eng.expert_load_bytes - bytes0,
            "admitted": {rid: eng.requests[rid].admit_time for rid in ids
                         if rid in eng.requests
                         and eng.requests[rid].admit_time is not None}}


def count_syncs(fn: Callable, device):
    """``fn()`` under torch's sync debug mode on the card: (result, the
    device-to-host syncs it made)."""
    import warnings
    if torch.device(device).type != "cuda":
        return fn(), None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            r = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return r, sum("synchroniz" in str(w.message) for w in caught)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", cell: Optional[dict] = None,
        config: Optional[dict] = None, traffic: Optional[dict] = None,
        rate: Optional[float] = None, control: bool = False,
        hook: Optional[Callable] = None, t_start: Optional[float] = None
        ) -> dict:
    """One run of ``workload``; specs default to the files of its name.
    ``hook(eng)`` runs on the built engine (the tests plant faults with
    it).  Returns the readings, the check and the context of the
    per-layer readers."""
    t_start = time.time() if t_start is None else t_start
    cell = cell or load("cells", workload)
    config = config or load("configs", cell["config"])
    traffic = traffic or load("traffic", cell["traffic"])
    rate = cell["rate"] if rate is None else rate
    cuda = torch.device(device).type == "cuda"

    for k, pub, ran, why in port_departures(config):
        log(f"the port departs from the published {k}={pub!r}: runs "
            f"{ran!r} ({why}); so does the reference")
    model, params = build(cell, config, seed, device)
    eng = engine(cell, model, params)
    if hook is not None:
        hook(eng)
    tr = T.build(traffic, rate=rate, seconds=seconds, slots=cell["slots"],
                 max_len=cell["max_len"], vocab=config["vocab_size"],
                 seed=seed)
    warm_up(eng, tr.warmup, cell["quantum"])
    log(memory_line(config, params, eng, cuda))

    recorder = prof = None
    if trace:
        from bench.tracing import Profiler, Recorder
        recorder, prof = Recorder(), Profiler(cuda)
    setup_s = time.time() - t_start
    win, syncs = count_syncs(lambda: measure(
        eng, tr.window, seconds, recorder=recorder, profiler=prof), device) \
        if trace else (measure(eng, tr.window, seconds), None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    e2e = W.end_to_end(win["arrivals"], win["events"], win["end"])
    e2e["setup_s"] = setup_s
    late = W.lateness(win["arrivals"], win["bounds"])
    waits = W.queue_waits(win["arrivals"], win["admitted"], win["end"])
    served = {rid: (tuple(eng.prompts[rid]), list(eng.outputs[rid]))
              for rid in eng.outputs}
    finished = [rid for rid, r in eng.requests.items()
                if r.state.name == "DONE" and rid in served]
    log(f"requests: {len(tr.warmup)} warm-up, {len(tr.window)} scheduled "
        f"in the window ({len(win['admitted'])} admitted, "
        f"{e2e['n_first_tokens']} first tokens); {len(win['events'])} "
        f"tokens in {win['iterations']} iterations over {win['end']:.3f} s; "
        f"{len(finished)} finished; prompts clipped {tr.clipped}")
    log("end to end, every reading whether the cell reports it or not: "
        + json.dumps(e2e))
    if late:
        log(f"injection late by mean {1e3 * sum(late) / len(late):.1f} ms, "
            f"max {1e3 * max(late):.1f} ms")

    rc = run_config(config)
    arch = reference(config).arch(rc)
    ctx = {"window_s": win["end"], "iterations": win["iterations"],
           "queue_waits": waits, "expert_bytes": win["expert_bytes"],
           "syncs": syncs, "arch": arch}
    dec_flops = len(win["events"]) * sum(arch["layer_flops"])
    log(f"whole-step mfu, decode tokens' matrix FLOPs only: "
        f"{dec_flops / (win['end'] * work.PEAK_FLOPS):.6f}")
    if trace:
        from bench import tracing
        red = tracing.reduce(prof.events())
        ctx.update(trace=red, work=tracing.work(recorder, arch))
        if red:
            log(f"profiled {red['n_device_ops']} device operations, "
                f"{red['unlinked']} without a launch record; busy "
                f"{red['busy_s']:.4f} of {red['window_s']:.4f} s")
        mfu = sum(ctx["work"].get(f"model.{p}.flops", 0.0)
                  for p in ("prefill", "decode"))
        log(f"whole-step mfu: {mfu / (win['end'] * work.PEAK_FLOPS):.6f}")
        del prof, recorder

    # the check, after the program's state is freed
    del eng
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = reference(config)
    if cuda:
        from bench.reference.common import fp32_matmuls
        fp32_matmuls()
    from bench.weights import Weights
    w = Weights(params)
    pick = C.sample(served, finished, list(win["arrivals"]), seed,
                    cell["check"]["requests"], cell["check"]["tokens"])
    t0 = time.time()
    judged = [C.gaps(ref, rc, w, *served[rid], device, control)
              for rid in pick]
    check_s = time.time() - t0
    got = C.readings([j["program"] for j in judged])
    log(f"check: {len(pick)} requests, "
        f"{sum(j['program']['tokens'] for j in judged)} served tokens in "
        f"{check_s:.2f} s: " + json.dumps(got))
    out = {"e2e": e2e, "ctx": ctx, "gap": got[C.NUMBER],
           "readings": got, "check_s": check_s, "peak": peak,
           "attempted": len(win["arrivals"]),
           "failed": sum(1 for rid in win["arrivals"]
                         if rid in served and any(
                             not 0 <= t < config["vocab_size"]
                             for t in served[rid][1])),
           "limit": cell["check"]["limit"], "sample": pick,
           "backlog": [(f, backlog(win, f * win["end"]))
                       for f in (0.25, 0.5, 0.75, 1.0)]}
    if control:
        out["control"] = C.readings([j["control"] for j in judged])
        out["control_correct"] = out["control"][C.NUMBER] <= out["limit"]
        log("control (fp8 operands): " + json.dumps(out["control"])
            + f"; correct {out['control_correct']}")
    return out


def port_departures(config: dict) -> list:
    from bench import port as P
    return P.departures(port(config), config)


def backlog(win: dict, t: float) -> int:
    """Requests that had arrived by ``t`` and were not yet admitted."""
    return sum(1 for rid, a in win["arrivals"].items() if a <= t
               and not win["admitted"].get(rid, float("inf")) <= t)


def memory_line(config: dict, params, eng, cuda: bool) -> str:
    from bench.weights import nbytes
    cache = sum(t.numel() * t.element_size() for seg in eng.cache
                for c in seg for t in c.values())
    s = (f"memory: weights {nbytes(params) / 1e9:.3f} GB, slot-row cache "
         f"{cache / 1e9:.3f} GB; the file's reckoning "
         f"{json.dumps(config.get('memory_gb', {}))}")
    if cuda:
        free, total = torch.cuda.mem_get_info()
        s += (f"; after warm-up {torch.cuda.memory_allocated() / 1e9:.3f} GB "
              f"allocated, {free / 1e9:.3f} of {total / 1e9:.3f} GB free")
    return s
