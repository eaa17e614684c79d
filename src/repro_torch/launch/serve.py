"""Serving launcher of the port: the real-execution engine, on the card by
default, in a closed loop, replaying a timed open-loop trace, or behind
the live HTTP/SSE front-end — or the discrete-event simulator.

The model runs at its full configured width (``--smoke`` selects the
reduced variant); weights are random, drawn from ``--seed``.  The same
``ServingRuntime`` loop as the JAX package drives the engine: closed-loop
drain on the iteration clock by default, open-loop replay of
``ServeConfig.engine_trace`` with ``--open-loop`` (on the iteration clock,
or on the wall clock with ``--clock wall``).  Every flag lives on
``ServeConfig`` (launch/config.py).  The report prints the JAX launcher's
``[serve]`` lines plus each kernel's launch count.

``--disagg`` serves two pools under one ``DisaggRuntime`` clock: a
prefill pool running ``--scheduler`` and a decode pool running the
decode-only scheduler, two engines over ONE copy of the weights, each
prompt's KV handed off through pinned host memory per layer group
(``--handoff stream``) or whole (``--handoff whole``); it prints the JAX
launcher's ``[serve-disagg]`` lines.  ``--fault-plan`` turns on chaos mode
(injected executor crashes, link drops and delays, swap-DMA failures,
pressure spikes and client disconnects, recovered within
``--retry-budget`` retries per request) for either loop and prints the
``chaos:`` line.

``--http HOST:PORT`` serves the engine live (``serving/server.py``): the
engine loop runs on a background thread on the wall clock while asyncio
ingests ``POST /v1/generate`` and streams tokens back as server-sent
events; on the card the kernels are built before the socket binds.
``--simulate`` runs the analytic simulator (``serving/simulator.py``) at
the config's full scale on ``--dataset``'s length model and prints the JAX
launcher's ``[serve-sim]`` lines (``--disagg``: two pools); it launches
nothing on a device, and its times are modelled for the ``--hw`` preset.
``--no-packed`` launches every prefill slice on its own (the per-slice
reference path).

Usage:
  # on the card, full qwen3-30b-a3b, layered prefill, closed loop:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-30b-a3b \\
      --scheduler layered --requests 4 --max-len 2048

  # open-loop Poisson replay on the wall clock (1.3 req/s):
  PYTHONPATH=src python -m repro_torch.launch.serve --open-loop \\
      --clock wall --requests 8 --max-len 2048

  # speculative verify-k decoding with the n-gram drafter (or a draft
  # model: --spec draft --draft-config qwen3-30b-a3b, its smoke variant):
  PYTHONPATH=src python -m repro_torch.launch.serve --spec ngram --spec-k 4

  # gpt-oss-20b, swap preemption in an oversubscribed page pool:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gpt-oss-20b \\
      --preemption swap --pages 64 --slots 8

  # two pools, layered prefill pool, streaming KV handoff, chaos mode:
  PYTHONPATH=src python -m repro_torch.launch.serve --disagg \\
      --handoff stream --fault-plan seed:7 --max-len 2048 --slots 8

  # on the CPU, reduced model (the kernels' plain versions run):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 2

  # live HTTP/SSE service on port 8000 (per-tenant rate limit 4 req/s):
  PYTHONPATH=src python -m repro_torch.launch.serve --http :8000 \\
      --max-len 2048 --slots 8 --ratelimit-rate 4
  curl -N localhost:8000/v1/generate \\
      -d '{"prompt_tokens": [1,2,3], "max_new_tokens": 8}'

  # the simulator at full scale (modelled times, h100x2 preset):
  PYTHONPATH=src python -m repro_torch.launch.serve --simulate \\
      --dataset arxiv --rate 1.3 --requests 100
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import make_scheduler
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.config import ServeConfig
from repro_torch.models.model import DecoderModel
from repro_torch.serving.cost_model import H100X2, TPU_V5E
from repro_torch.serving.engine import Engine, EngineHandoff
from repro_torch.serving.faults import FaultInjector, FaultPlan
from repro_torch.serving.metrics import per_class_metrics, request_metrics
from repro_torch.serving.runtime import (DisaggRuntime, EngineExecutor,
                                         ServingRuntime)
from repro_torch.serving.server import ServingServer
from repro_torch.serving.simulator import DisaggSimulator, Simulator
from repro_torch.serving.traffic import (ARRIVAL_PROCESSES, DATASETS,
                                         ClassSpec, multi_class_trace)


def model_config(a: ServeConfig):
    cfg = get_smoke_config(a.arch) if a.smoke else get_config(a.arch)
    if a.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=a.dtype, param_dtype=a.dtype)
    return cfg


def build_model(a: ServeConfig):
    """The model and its random parameters (drawn on the device from
    ``a.seed``) — shared by every engine a caller builds over them."""
    model = DecoderModel(model_config(a), device=resolve_device(a.device))
    gen = torch.Generator(device=model.device).manual_seed(a.seed)
    return model, model.init_params(gen)


def build_engine(a: ServeConfig, model=None, params=None) -> Engine:
    """The engine of one run (builds the model unless one is given)."""
    if model is None:
        model, params = build_model(a)
    sched = make_scheduler(a.scheduler, model.n_blocks,
                           **a.scheduler_kwargs())
    return Engine(model, params, sched, **a.engine_kwargs())


def _print_token(rid, tok, t) -> None:
    print(f"[stream] t={t:8.2f} req={rid:<4} tok={tok}")


def _arrivals(eng: Engine, a: ServeConfig, trace):
    """The run's trace: ``trace`` (default ``a.engine_trace``) in the open
    loop; in the closed loop the requests are submitted to ``eng`` now and
    the trace is empty."""
    if a.open_loop:
        return a.engine_trace(eng.cfg.vocab_size) if trace is None else trace
    submit_closed_loop(eng, a)
    return ()


def _timed_run(runtime, trace, device):
    """``runtime.run(trace)`` and its wall seconds on the host clock,
    synchronized with the card at both ends."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = runtime.run(trace, max_iterations=100_000)
    if cuda:
        torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def submit_closed_loop(eng: Engine, a: ServeConfig) -> None:
    """Closed-loop requests with random prompts drawn from ``a.seed``."""
    rng = np.random.default_rng(a.seed)
    lo, hi = a.prompt_len or (16, a.max_len // 2)
    nlo, nhi = a.new_tokens or (4, 16)
    for _ in range(a.requests):
        n = int(rng.integers(lo, hi))
        eng.submit(rng.integers(1, eng.cfg.vocab_size, n).tolist(),
                   max_new_tokens=int(rng.integers(nlo, nhi)))


def _f(v, spec: str = ".2f") -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return "-"
    return format(v, spec)


def _print_per_class(tag: str, requests, slo=None) -> None:
    per = per_class_metrics(requests, slo)
    if len(per) < 2:
        return
    for cls, m in per.items():
        att = f" slo={_f(m['slo_attainment'])}" if "slo_attainment" in m \
            else ""
        print(f"[{tag}]   class {cls:<12} n={m['n_requests']:.0f} "
              f"ttft mean={_f(m['ttft_mean'])} p99={_f(m['ttft_p99'])}; "
              f"preempt rate {_f(m['preemption_rate'])}/req; "
              f"swap rate {_f(m['swap_rate'])}/req{att}")


def build_faults(a: ServeConfig) -> Optional[FaultInjector]:
    """Chaos mode: a deterministic ``FaultInjector`` from ``--fault-plan``
    ('@file.json' | 'seed:N' | inline JSON), or None when off."""
    if a.fault_plan is None:
        return None
    return FaultInjector(FaultPlan.load(a.fault_plan))


def _print_faults(tag: str, fi: Optional[FaultInjector], requests) -> None:
    """Chaos-run report line: what was injected and what got shed (a
    DONE request with ``shed_reason`` set never completed)."""
    if fi is None:
        return
    shed: dict = {}
    for r in requests:
        if r.shed_reason is not None:
            shed[r.shed_reason] = shed.get(r.shed_reason, 0) + 1
    inj = ", ".join(f"{k[2:]}={v}" for k, v in sorted(fi.counters.items())
                    if v)
    sheds = ", ".join(f"{k}={v}" for k, v in sorted(shed.items()))
    print(f"[{tag}] chaos: {sum(fi.counters.values())} faults injected"
          + (f" ({inj})" if inj else "")
          + (f"; shed {sheds}" if sheds else "; no requests shed"))


def _fault_report(fi: Optional[FaultInjector], runtime, reqs) -> dict:
    """The chaos run's numbers for the caller: injected-fault counters by
    kind, the runtime's ``fault_stats()`` and each shed request's
    reason."""
    return {"fault_counters": dict(fi.counters) if fi is not None else {},
            "fault_stats": runtime.fault_stats(),
            "shed": {r.req_id: r.shed_reason for r in reqs
                     if r.shed_reason is not None}}


def serve_real(a: ServeConfig, model=None, params=None, trace=None) -> dict:
    """Build an engine and serve (``run_engine``)."""
    return run_engine(build_engine(a, model, params), a, trace)


def run_engine(eng: Engine, a: ServeConfig, trace=None) -> dict:
    """Serve on ``eng``: closed loop (``a.requests`` random requests
    submitted up front, drained on the iteration clock) or, with
    ``a.open_loop``, a timed replay of ``trace`` (default
    ``a.engine_trace``) on the iteration clock or, with ``a.clock ==
    "wall"``, on the wall clock.  Prints the report and returns its
    numbers; TTFT/TBT are in the clock's unit (seconds on the wall clock,
    iterations otherwise).  Speculation is the engine's own; with
    ``a.fault_plan`` the runtime injects its faults (chaos mode)."""

    faults = build_faults(a)
    wall_clock = a.open_loop and a.clock == "wall"
    trace = _arrivals(eng, a, trace)
    runtime = ServingRuntime(
        EngineExecutor(eng, wall=wall_clock),
        on_token=_print_token if a.stream else None,
        clock="executor" if wall_clock else "iteration", faults=faults,
        retry_budget=a.retry_budget)
    unit = "s" if wall_clock else "iters"
    _, wall = _timed_run(runtime, trace, eng.device)
    reqs = list(eng.requests.values())
    m = request_metrics(reqs)
    cfg = eng.cfg
    loop = "open-loop" if a.open_loop else "closed-loop"
    print(f"[serve] {cfg.name} x {a.scheduler} ({loop}, "
          f"{cfg.n_layers} layers, {a.moe_dispatch} MoE dispatch, "
          f"{eng.device}): {len(reqs)} requests in "
          f"{eng.iteration} iterations")
    if a.recurrent_mixers():
        kinds = collections.Counter(sp.mixer for sp in eng.model.specs)
        print("[serve] mixers " + ", ".join(
            f"{k} x{n}" for k, n in sorted(kinds.items()))
            + f"; recurrent state {eng.state_bytes_per_slot / 1e6:.3f} MB "
            "a slot; prefix cache off (recurrent state has no position "
            "axis to restore at a page boundary)")
    print(f"[serve] ttft({unit}) mean={_f(m['ttft_mean'], '.3g')} "
          f"p50={_f(m['ttft_p50'], '.3g')} p99={_f(m['ttft_p99'], '.3g')}; "
          f"tbt({unit}) p50={_f(m['tbt_p50'], '.3g')} "
          f"p99={_f(m['tbt_p99'], '.3g')}; expert-load "
          f"{eng.expert_load_bytes / 1e6:.1f} MB")
    print(f"[serve] kv pages high-water {eng.alloc.pages_high_water}"
          f"/{eng.alloc.n_pages}; queue delay mean "
          f"{_f(m['queue_delay_mean'], '.3g')} {unit}; "
          f"preemptions {eng.n_preempted} "
          f"(rate {_f(m['preemption_rate'])}/req)")
    print(f"[serve] hot path: {'packed' if eng.packed else 'per-slice'}; "
          f"{eng.n_dispatches} device launches "
          f"({eng.n_dispatches / max(eng.iteration, 1):.1f}/iter), "
          f"{eng.n_prefill_dispatches} prefill batches; "
          f"{wall * 1e3 / max(eng.iteration, 1):.1f} ms/iter wall")
    if eng.spec_mode != "off":
        acc = m["spec_acceptance_rate"]
        tpd = (sum(r.n_generated for r in reqs)
               / max(eng.n_dispatches, 1))
        print(f"[serve] spec({eng.spec_mode}, k={eng.spec_k}): "
              f"{eng.n_spec_proposed} drafted, {eng.n_spec_accepted} "
              f"accepted (rate {_f(acc)}); accepted len "
              f"p50={_f(m['accepted_len_p50'], '.1f')} "
              f"p90={_f(m['accepted_len_p90'], '.1f')}; "
              f"{eng.n_verify_dispatches} verify + "
              f"{eng.n_draft_dispatches} draft launches; "
              f"{tpd:.2f} generated tokens/launch")
    if eng.prefix_cache:
        print(f"[serve] prefix cache: hit rate "
              f"{m['prefix_hit_rate']:.2f} "
              f"({eng.alloc.n_prefix_hits} hits, "
              f"{eng.alloc.n_prefix_tokens} cached tokens, "
              f"{eng.n_prefix_restores} row restores); "
              f"{eng.alloc.n_shared_pages} shared pages live, "
              f"{eng.alloc.n_prefix_evictions} LRU reclaims")
    if eng.alloc.n_host_pages:
        print(f"[serve] swap: {eng.n_swapped_out} out / "
              f"{eng.n_swapped_in} in; host pages high-water "
              f"{eng.alloc.host_pages_high_water}/{eng.alloc.n_host_pages};"
              f" restore latency mean "
              f"{_f(m['restore_latency_mean'], '.3g')} {unit}")
    print("[serve] kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in ops.LAUNCHES.items()))
    _print_faults("serve", faults, reqs)
    _print_per_class("serve", reqs, a.slo())
    done = sum(r.finish_time is not None and r.shed_reason is None
               for r in reqs)
    return {"iterations": eng.iteration, "wall_s": wall,
            "ms_per_iter": wall * 1e3 / max(eng.iteration, 1),
            "expert_load_bytes": eng.expert_load_bytes,
            "completed": done, "requests": len(reqs),
            "generated": sum(len(v) for v in eng.outputs.values()),
            "outputs": {rid: list(t) for rid, t in eng.outputs.items()},
            "prompts": {r.req_id: list(r.prompt_tokens) for r in reqs},
            "max_new": {r.req_id: r.max_new_tokens for r in reqs},
            "n_preempted": eng.n_preempted,
            "n_swapped_out": eng.n_swapped_out,
            "n_swapped_in": eng.n_swapped_in,
            "swapped_ids": sorted(r.req_id for r in reqs if r.n_swaps),
            "n_prefix_hits": eng.alloc.n_prefix_hits,
            "n_prefix_tokens": eng.alloc.n_prefix_tokens,
            "n_prefix_restores": eng.n_prefix_restores,
            "spec": eng.spec_mode, "spec_k": eng.spec_k,
            "n_verify_dispatches": eng.n_verify_dispatches,
            "n_draft_dispatches": eng.n_draft_dispatches,
            "n_spec_proposed": eng.n_spec_proposed,
            "n_spec_accepted": eng.n_spec_accepted,
            "clock_unit": unit, "pages_left": eng.alloc.pages_in_use(),
            "host_pages_left": eng.alloc.host_pages_in_use(),
            **_fault_report(faults, runtime, reqs),
            **{k: m[k] for k in ("ttft_p50", "ttft_p99", "tbt_p50",
                                 "tbt_p99")}}


def build_disagg_engines(a: ServeConfig, model=None, params=None):
    """(prefill, decode) Engine pair over ONE model and ONE set of weights
    (two copies of a full-size model would not fit on one card): the
    prefill pool runs ``a.scheduler``, the decode pool the internal
    decode-only scheduler (residents arrive via ``adopt``), with
    ``a.decode_pages`` pages (default: the prefill pool's)."""
    if model is None:
        model, params = build_model(a)
    sp = make_scheduler(a.scheduler, model.n_blocks, **a.scheduler_kwargs())
    sd = make_scheduler("decode", model.n_blocks, **a.scheduler_kwargs())
    ekw = a.engine_kwargs()
    dkw = dict(ekw, pages=a.decode_pages if a.decode_pages is not None
               else ekw["pages"])
    return (Engine(model, params, sp, **ekw),
            Engine(model, params, sd, **dkw))


def serve_disagg_real(a: ServeConfig, model=None, params=None,
                      trace=None) -> dict:
    """Build the two pools and serve (``run_disagg``)."""
    return run_disagg(*build_disagg_engines(a, model, params), a, trace)


def run_disagg(ep: Engine, ed: Engine, a: ServeConfig, trace=None) -> dict:
    """Two-pool serve on the iteration clock: the prefill engine ``ep``
    and the decode engine ``ed`` under one ``DisaggRuntime``, the KV
    handed off through ``EngineHandoff`` (``a.handoff``: stream or
    whole).  Closed loop (``a.requests`` random requests submitted to the
    prefill pool up front) or, with ``a.open_loop``, a replay of ``trace``
    (default ``a.engine_trace``) with arrival times in iterations.  Prints
    the JAX launcher's ``[serve-disagg]`` lines (plus each pool's expert
    bytes, ms/iter and kernel launches) and returns its numbers."""

    bridge = EngineHandoff(ep, ed, streaming=a.handoff == "stream")
    faults = build_faults(a)
    runtime = DisaggRuntime(
        EngineExecutor(ep), EngineExecutor(ed), bridge,
        on_token=_print_token if a.stream else None, clock="iteration",
        decode_watermark_pages=a.decode_watermark,
        faults=faults, retry_budget=a.retry_budget)
    rr, wall = _timed_run(runtime, _arrivals(ep, a, trace), ep.device)
    reqs = sorted(rr.requests, key=lambda r: r.req_id)
    m = request_metrics(reqs)
    cfg = ep.cfg
    loop = "open-loop" if a.open_loop else "closed-loop"
    print(f"[serve-disagg] {cfg.name} x {a.scheduler}+decode ({loop}, "
          f"{a.handoff} handoff): {a.requests} requests in "
          f"{rr.n_prefill_iterations} prefill + "
          f"{rr.n_decode_iterations} decode iterations")
    print(f"[serve-disagg] ttft(iters) mean={_f(m['ttft_mean'], '.1f')} "
          f"p99={_f(m['ttft_p99'], '.1f')}; "
          f"{rr.n_migrations} migrations ({rr.n_returns} returns), "
          f"{rr.handoff_bytes / 1e6:.1f} MB handed off, "
          f"queue peak {rr.migration_queue_peak}")
    print(f"[serve-disagg] handoff chunks/req "
          f"{_f(m['handoff_chunks_mean'], '.1f')}; link ratio "
          f"{_f(m['handoff_link_ratio'])}; decode-pool prefill slices "
          f"{rr.decode_prefill_slices} (must stay 0)")
    print(f"[serve-disagg] kv high-water prefill "
          f"{ep.alloc.pages_high_water}/{ep.alloc.n_pages}, decode "
          f"{ed.alloc.pages_high_water}/{ed.alloc.n_pages}; "
          f"preemptions {ep.n_preempted}+{ed.n_preempted}")
    print(f"[serve-disagg] expert-load prefill "
          f"{ep.expert_load_bytes / 1e6:.1f} MB + decode "
          f"{ed.expert_load_bytes / 1e6:.1f} MB; "
          f"{wall * 1e3 / max(rr.n_iterations, 1):.1f} ms/iter wall; "
          "kernel launches: " + ", ".join(
              f"{k} {v}" for k, v in ops.LAUNCHES.items()))
    _print_faults("serve-disagg", faults, reqs)
    _print_per_class("serve-disagg", reqs)
    outputs = {**ep.outputs, **ed.outputs}
    return {"iterations": rr.n_iterations,
            "n_prefill_iterations": rr.n_prefill_iterations,
            "n_decode_iterations": rr.n_decode_iterations,
            "wall_s": wall,
            "ms_per_iter": wall * 1e3 / max(rr.n_iterations, 1),
            "expert_load_bytes": ep.expert_load_bytes + ed.expert_load_bytes,
            "expert_load_bytes_prefill": ep.expert_load_bytes,
            "expert_load_bytes_decode": ed.expert_load_bytes,
            "completed": sum(r.finish_time is not None
                             and r.shed_reason is None for r in reqs),
            "requests": len(reqs),
            "outputs": {rid: [int(x) for x in t]
                        for rid, t in sorted(outputs.items())},
            "prompts": {r.req_id: list(r.prompt_tokens) for r in reqs},
            "max_new": {r.req_id: r.max_new_tokens for r in reqs},
            "n_migrations": rr.n_migrations, "n_returns": rr.n_returns,
            "handoff_bytes": rr.handoff_bytes,
            "migration_queue_peak": rr.migration_queue_peak,
            "decode_prefill_slices": rr.decode_prefill_slices,
            "n_preempted": ep.n_preempted + ed.n_preempted,
            "n_swapped_out": ep.n_swapped_out + ed.n_swapped_out,
            "pages_left": ep.alloc.pages_in_use() + ed.alloc.pages_in_use(),
            "host_pages_left": (ep.alloc.host_pages_in_use()
                                + ed.alloc.host_pages_in_use()),
            **_fault_report(faults, runtime, reqs),
            **{k: m[k] for k in ("ttft_p50", "ttft_p99", "tbt_p50",
                                 "tbt_p99")}}


def prepare_kernels(device: torch.device) -> None:
    """On the card, build and load every kernel now, so that no request
    waits out a build at its first launch (a no-op on the CPU)."""
    if device.type != "cuda":
        return
    from repro_torch.kernels import build
    build.build_all()
    for name in build.KERNELS:
        build.load(name)


def build_server(a: ServeConfig, model=None, params=None,
                 **server_kw) -> ServingServer:
    """The live HTTP/SSE front-end over a fresh engine (over ``model`` and
    ``params`` when given), its kernels built before the socket binds;
    ``server_kw`` overrides ``a.server_kwargs()``."""
    eng = build_engine(a, model, params)
    prepare_kernels(eng.device)
    return ServingServer(eng, faults=build_faults(a),
                         **dict(a.server_kwargs(), **server_kw))


def serve_http(a: ServeConfig, model=None, params=None) -> None:
    """Live HTTP/SSE service: the engine iteration loop runs on a
    background thread on the wall clock while asyncio ingests requests
    concurrently (serving/server.py)."""
    build_server(a, model, params).serve_forever()


def serve_sim(a: ServeConfig):
    """The discrete-event simulator at the config's full scale: prints the
    JAX launcher's ``[serve-sim]`` lines and returns the ``SimResult``
    (``DisaggSimResult`` with ``--disagg``).  Every time it prints is
    modelled for the ``--hw`` preset; nothing runs on a device."""
    cfg = get_config(a.arch)
    hw = H100X2 if a.hw == "h100x2" else TPU_V5E
    if a.host_bw is not None:
        hw = dataclasses.replace(hw, host_bw=a.host_bw * 1e9)
    if a.batch_fraction > 0:
        # multi-tenant mix: interactive foreground on the chosen dataset,
        # batch-class arXiv background on the selected arrival process
        n_batch = int(round(a.requests * a.batch_fraction))
        trace = multi_class_trace([
            ClassSpec("interactive", DATASETS[a.dataset],
                      a.rate * (1 - a.batch_fraction),
                      a.requests - n_batch),
            ClassSpec("batch", DATASETS["arxiv"],
                      a.rate * a.batch_fraction, n_batch,
                      process=a.arrival),
        ], seed=a.seed)
    else:
        trace = ARRIVAL_PROCESSES[a.arrival](
            DATASETS[a.dataset], a.rate, a.requests, seed=a.seed)
    if a.disagg:
        return _serve_sim_disagg(a, cfg, hw, trace)
    sim = Simulator(cfg, a.scheduler, hw, **a.sim_kwargs())
    faults = build_faults(a)
    res = sim.run(trace, faults=faults, retry_budget=a.retry_budget)
    slo = a.slo()
    m = request_metrics(res.requests, slo)
    print(f"[serve-sim] {cfg.name} x {a.scheduler} on {a.dataset} "
          f"@{a.rate} req/s ({hw.name}; "
          f"{sim.kv.n_pages} x {sim.kv.page_size}-token pages)")
    for k in ("ttft_mean", "ttft_p99", "tbt_mean", "tbt_p99",
              "slo_attainment", "e2e_mean", "queue_delay_mean",
              "queue_delay_p99", "preemption_rate"):
        print(f"[serve-sim]   {k:<16} {_f(m[k], '.3f')}")
    print(f"[serve-sim]   energy/token     "
          f"{res.energy_per_token * 1e3:.1f} mJ")
    print(f"[serve-sim]   expert traffic   "
          f"{res.total_expert_bytes / 1e12:.2f} TB")
    print(f"[serve-sim]   kv pages         "
          f"high-water {res.pages_high_water}/{res.n_pool_pages}; "
          f"{res.n_preemptions} preemptions, "
          f"{res.recompute_tokens} recomputed tokens")
    if a.prefix_cache_on():
        print(f"[serve-sim]   prefix cache     "
              f"hit rate {res.prefix_hit_rate:.2f} "
              f"({res.n_prefix_hits} hits, "
              f"{res.prefix_cached_tokens} cached tokens)")
    if a.spec != "off":
        print(f"[serve-sim]   spec({a.spec})      "
              f"{res.total_drafted} drafted / {res.total_accepted} "
              f"accepted (rate {_f(res.acceptance_rate)}); accepted len "
              f"p50={_f(m['accepted_len_p50'], '.1f')} "
              f"p90={_f(m['accepted_len_p90'], '.1f')}")
    if res.n_host_pages:
        print(f"[serve-sim]   swap             "
              f"{res.n_swap_outs} out / {res.n_swap_ins} in; "
              f"{res.swap_bytes / 1e9:.2f} GB over host link, "
              f"{res.swap_dma_time:.3f} s DMA ({res.swap_stall_time:.3f} s"
              f" unhidden stall); host pages "
              f"high-water {res.host_pages_high_water}/{res.n_host_pages};"
              f" restore latency mean "
              f"{_f(m['restore_latency_mean'], '.3f')} s")
    _print_faults("serve-sim", faults, res.requests)
    _print_per_class("serve-sim", res.requests, slo)
    return res


def _serve_sim_disagg(a: ServeConfig, cfg, hw, trace):
    """Two-pool analytic serving report: per-pool rollups plus the link
    accounting the monolithic report has no column for."""
    sim = DisaggSimulator(cfg, a.scheduler, hw, handoff=a.handoff,
                          decode_pages=a.decode_pages,
                          decode_watermark=a.decode_watermark,
                          **a.sim_kwargs())
    faults = build_faults(a)
    res = sim.run(trace, faults=faults, retry_budget=a.retry_budget)
    slo = a.slo()
    m = request_metrics(res.requests, slo)
    print(f"[serve-sim] {cfg.name} x {a.scheduler}+decode on "
          f"{a.dataset} @{a.rate} req/s ({hw.name}; {a.handoff} "
          f"handoff; decode pool "
          f"{sim.decode.kv.n_pages} x {sim.decode.kv.page_size}-token "
          f"pages)")
    for k in ("ttft_mean", "ttft_p99", "tbt_mean", "tbt_p99",
              "slo_attainment", "e2e_mean", "queue_delay_mean",
              "preemption_rate"):
        print(f"[serve-sim]   {k:<16} {_f(m[k], '.3f')}")
    n_tok = sum(r.n_generated for r in res.requests) or 1
    print(f"[serve-sim]   energy/token     "
          f"{res.total_energy / n_tok * 1e3:.1f} mJ "
          f"(link {res.link_energy * 1e3:.1f} mJ total)")
    print(f"[serve-sim]   handoff          "
          f"{res.n_migrations} migrations ({res.n_returns} returns); "
          f"{res.link_bytes / 1e9:.2f} GB over link, "
          f"{res.link_stall_time:.4f} s unhidden stall, "
          f"{res.handoff_wait_time:.4f} s watermark wait; "
          f"queue peak {res.migration_queue_peak}")
    print(f"[serve-sim]   decode pool      "
          f"tbt mean {_f(res.decode_pool_tbt_mean, '.4f')} s over "
          f"{res.decode.n_iterations} iterations; prefill slices "
          f"{res.decode_prefill_slices} (must stay 0)")
    print(f"[serve-sim]   kv pages         "
          f"prefill high-water "
          f"{res.prefill.pages_high_water}/{res.prefill.n_pool_pages}, "
          f"decode {res.decode.pages_high_water}"
          f"/{res.decode.n_pool_pages}; "
          f"{res.prefill.n_preemptions + res.decode.n_preemptions} "
          f"preemptions")
    _print_faults("serve-sim", faults, res.requests)
    _print_per_class("serve-sim", res.requests, slo)
    return res


def parse_args(argv=None) -> ServeConfig:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ServeConfig.add_arguments(ap)
    return ServeConfig.from_args(ap.parse_args(argv))


def main(argv=None) -> None:
    a = parse_args(argv)
    if a.simulate:
        serve_sim(a)
    elif a.http is not None:
        serve_http(a)
    elif a.disagg:
        serve_disagg_real(a)
    else:
        serve_real(a)


if __name__ == "__main__":
    main()
