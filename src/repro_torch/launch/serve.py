"""Serving launcher of the port: the real-execution engine in a closed loop,
on the card by default.

The model runs at its full configured width (``--smoke`` selects the
reduced variant); weights are random, drawn from ``--seed``.  The same
``ServingRuntime`` loop as the JAX package drives the engine on the
iteration clock, and the report prints the JAX launcher's ``[serve]``
lines plus each kernel's launch count.

Usage:
  # on the card, full qwen3-30b-a3b, layered prefill:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-30b-a3b \\
      --scheduler layered --requests 4 --max-len 2048

  # the dense (E, C, d) capacity-buffer MoE dispatch instead of ragged:
  PYTHONPATH=src python -m repro_torch.launch.serve --moe-dispatch dense \\
      --requests 4 --max-len 512

  # on the CPU, reduced model (the kernels' plain versions run):
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \\
      --requests 2
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_configs
from repro_torch.core import SCHEDULERS, make_scheduler
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.model import DecoderModel
from repro_torch.serving.engine import Engine
from repro_torch.serving.metrics import request_metrics
from repro_torch.serving.runtime import EngineExecutor, ServingRuntime


@dataclasses.dataclass
class ServeArgs:
    arch: str = "qwen3-30b-a3b"
    smoke: bool = False
    scheduler: str = "layered"
    requests: int = 8
    max_len: int = 256
    slots: int = 8
    quantum: int = 512
    token_budget: int = 512
    moe_dispatch: str = "ragged"
    seed: int = 0
    dtype: Optional[str] = None        # None: the config's own dtypes
    device: Optional[str] = None       # None: cuda
    # closed-loop traffic: prompt lengths and new tokens are drawn
    # uniformly from [lo, hi); None keeps the JAX launcher's ranges
    prompt_len: Optional[Tuple[int, int]] = None
    new_tokens: Optional[Tuple[int, int]] = None


def model_config(a: ServeArgs):
    cfg = get_smoke_config(a.arch) if a.smoke else get_config(a.arch)
    if a.dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=a.dtype, param_dtype=a.dtype)
    return cfg


def build_model(a: ServeArgs):
    """The model and its random parameters (drawn on the device from
    ``a.seed``) — shared by every engine a caller builds over them."""
    model = DecoderModel(model_config(a), device=resolve_device(a.device))
    gen = torch.Generator(device=model.device).manual_seed(a.seed)
    return model, model.init_params(gen)


def build_engine(a: ServeArgs, model=None, params=None) -> Engine:
    """The engine of one run (builds the model unless one is given)."""
    if model is None:
        model, params = build_model(a)
    sched = make_scheduler(a.scheduler, model.n_blocks, n_slots=a.slots,
                           quantum=a.quantum, token_budget=a.token_budget)
    return Engine(model, params, sched, n_slots=a.slots, max_len=a.max_len,
                  moe_dispatch=a.moe_dispatch)


def submit_closed_loop(eng: Engine, a: ServeArgs) -> None:
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


def serve_real(a: ServeArgs, model=None, params=None) -> dict:
    """Build an engine, serve ``a.requests`` closed-loop requests to
    completion, print the report and return its numbers."""
    eng = build_engine(a, model, params)
    submit_closed_loop(eng, a)
    cuda = eng.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ServingRuntime(EngineExecutor(eng), clock="iteration").run(
        (), max_iterations=100_000)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = list(eng.requests.values())
    m = request_metrics(reqs)
    cfg = eng.cfg
    print(f"[serve] {cfg.name} x {a.scheduler} (closed-loop, "
          f"{cfg.n_layers} layers, {a.moe_dispatch} MoE dispatch, "
          f"{eng.device}): {a.requests} requests in "
          f"{eng.iteration} iterations")
    print(f"[serve] ttft(iters) mean={_f(m['ttft_mean'], '.1f')} "
          f"p99={_f(m['ttft_p99'], '.1f')}; expert-load "
          f"{eng.expert_load_bytes / 1e6:.1f} MB")
    print(f"[serve] kv pages high-water {eng.alloc.pages_high_water}"
          f"/{eng.alloc.n_pages}; queue delay mean "
          f"{_f(m['queue_delay_mean'], '.1f')} iters; "
          f"preemptions {eng.n_preempted} "
          f"(rate {_f(m['preemption_rate'])}/req)")
    print(f"[serve] hot path: packed; {eng.n_dispatches} device launches "
          f"({eng.n_dispatches / max(eng.iteration, 1):.1f}/iter), "
          f"{eng.n_prefill_dispatches} prefill batches; "
          f"{wall * 1e3 / max(eng.iteration, 1):.1f} ms/iter wall")
    print("[serve] kernel launches: " + ", ".join(
        f"{k} {v}" for k, v in ops.LAUNCHES.items()))
    done = sum(r.finish_time is not None for r in reqs)
    return {"iterations": eng.iteration, "wall_s": wall,
            "ms_per_iter": wall * 1e3 / max(eng.iteration, 1),
            "expert_load_bytes": eng.expert_load_bytes,
            "completed": done, "requests": len(reqs),
            "generated": sum(len(v) for v in eng.outputs.values()),
            "outputs": {rid: list(t) for rid, t in eng.outputs.items()},
            "n_preempted": eng.n_preempted}


def parse_args(argv=None) -> ServeArgs:
    d = ServeArgs()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=d.arch, choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="run the reduced variant of the config")
    ap.add_argument("--scheduler", default=d.scheduler,
                    choices=sorted(SCHEDULERS))
    ap.add_argument("--requests", type=int, default=d.requests)
    ap.add_argument("--max-len", type=int, default=d.max_len)
    ap.add_argument("--slots", type=int, default=d.slots)
    ap.add_argument("--quantum", type=int, default=d.quantum)
    ap.add_argument("--token-budget", type=int, default=d.token_budget)
    ap.add_argument("--moe-dispatch", default=d.moe_dispatch,
                    choices=["ragged", "dense"],
                    help="dropless MoE data path")
    ap.add_argument("--seed", type=int, default=d.seed)
    ap.add_argument("--dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="override the config's activation/param dtype")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ns = ap.parse_args(argv)
    return ServeArgs(arch=ns.arch, smoke=ns.smoke, scheduler=ns.scheduler,
                     requests=ns.requests, max_len=ns.max_len,
                     slots=ns.slots, quantum=ns.quantum,
                     token_budget=ns.token_budget,
                     moe_dispatch=ns.moe_dispatch, seed=ns.seed,
                     dtype=ns.dtype, device=ns.device)


def main(argv=None) -> None:
    serve_real(parse_args(argv))


if __name__ == "__main__":
    main()
