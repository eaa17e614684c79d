"""Serving launcher of the port: the real-execution engine, on the card by
default, in a closed loop or replaying a timed open-loop trace.

The model runs at its full configured width (``--smoke`` selects the
reduced variant); weights are random, drawn from ``--seed``.  The same
``ServingRuntime`` loop as the JAX package drives the engine: closed-loop
drain on the iteration clock by default, open-loop replay of
``ServeConfig.engine_trace`` with ``--open-loop`` (on the iteration clock,
or on the wall clock with ``--clock wall``).  Every flag lives on
``ServeConfig`` (launch/config.py).  The report prints the JAX launcher's
``[serve]`` lines plus each kernel's launch count.

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

  # on the CPU, reduced model (the kernels' plain versions run):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 2
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import make_scheduler
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.config import ServeConfig
from repro_torch.models.model import DecoderModel
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import per_class_metrics, request_metrics
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime


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


def _print_per_class(requests, slo=None) -> None:
    per = per_class_metrics(requests, slo)
    if len(per) < 2:
        return
    for cls, m in per.items():
        att = f" slo={_f(m['slo_attainment'])}" if "slo_attainment" in m \
            else ""
        print(f"[serve]   class {cls:<12} n={m['n_requests']:.0f} "
              f"ttft mean={_f(m['ttft_mean'])} p99={_f(m['ttft_p99'])}; "
              f"preempt rate {_f(m['preemption_rate'])}/req; "
              f"swap rate {_f(m['swap_rate'])}/req{att}")


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
    iterations otherwise).  Speculation is the engine's own."""

    def _stream(rid, tok, t):
        print(f"[stream] t={t:8.2f} req={rid:<4} tok={tok}")
    on_token = _stream if a.stream else None
    wall_clock = a.open_loop and a.clock == "wall"
    if a.open_loop:
        if trace is None:
            trace = a.engine_trace(eng.cfg.vocab_size)
        runtime = ServingRuntime(
            EngineExecutor(eng, wall=wall_clock), on_token=on_token,
            clock="executor" if wall_clock else "iteration")
    else:
        trace = ()
        submit_closed_loop(eng, a)
        runtime = ServingRuntime(EngineExecutor(eng), on_token=on_token,
                                 clock="iteration")
    unit = "s" if wall_clock else "iters"
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    runtime.run(trace, max_iterations=100_000)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = list(eng.requests.values())
    m = request_metrics(reqs)
    cfg = eng.cfg
    loop = "open-loop" if a.open_loop else "closed-loop"
    print(f"[serve] {cfg.name} x {a.scheduler} ({loop}, "
          f"{cfg.n_layers} layers, {a.moe_dispatch} MoE dispatch, "
          f"{eng.device}): {len(reqs)} requests in "
          f"{eng.iteration} iterations")
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
    print(f"[serve] hot path: packed; {eng.n_dispatches} device launches "
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
    if a.prefix_cache:
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
    _print_per_class(reqs, a.slo())
    done = sum(r.finish_time is not None for r in reqs)
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
            "clock_unit": unit,
            **{k: m[k] for k in ("ttft_p50", "ttft_p99", "tbt_p50",
                                 "tbt_p99")}}


def parse_args(argv=None) -> ServeConfig:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ServeConfig.add_arguments(ap)
    return ServeConfig.from_args(ap.parse_args(argv))


def main(argv=None) -> None:
    serve_real(parse_args(argv))


if __name__ == "__main__":
    main()
