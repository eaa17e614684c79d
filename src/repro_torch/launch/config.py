"""ServeConfig: the one typed configuration behind the port's serving
launcher, its HTTP front-end and its load generator — every field and flag
of the JAX package's ``ServeConfig`` (the simulator's, the HTTP
front-end's and ``packed`` included), plus the port's own ``dtype``,
``device``, ``prompt_len`` and ``new_tokens``.

  * ``add_arguments`` / ``from_args`` — the single argparse definition
    (serve.py and load_gen both call it, so flags can never drift),
  * ``validate`` — cross-field checks, raising ``ValueError`` with the
    offending field named,
  * ``to_json`` / ``from_json`` — lossless round-trip, so a run can record
    exactly the configuration it served,
  * ``engine_kwargs`` / ``scheduler_kwargs`` / ``sim_kwargs`` /
    ``server_kwargs`` — the derived constructor argument dicts,
  * ``engine_trace`` — builds the open-loop trace (the traffic module's
    generators with a length model shrunk to the engine's max_len).

Everything here is declarative: no model construction, no torch import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.configs import get_config, list_configs
from repro_torch.core.base import SCHEDULERS
from repro_torch.serving.metrics import SLOConfig
from repro_torch.serving.traffic import (ARRIVAL_PROCESSES, DATASETS,
                                         ClassSpec, DatasetModel,
                                         LengthModel, attach_prompt_tokens,
                                         multi_class_trace)


@dataclass
class ServeConfig:
    # model / scheduler
    arch: str = "qwen3-30b-a3b"
    scheduler: str = "layered"
    smoke: bool = False
    simulate: bool = False
    # loop shape
    open_loop: bool = False
    clock: str = "virtual"              # virtual | wall
    stream: bool = False
    # traffic
    dataset: str = "arxiv"
    arrival: str = "poisson"
    rate: float = 1.3
    requests: int = 8
    batch_fraction: float = 0.0
    class_headroom: int = 0
    seed: int = 0
    # batching / memory
    slots: int = 64
    quantum: int = 512
    token_budget: int = 512
    max_len: int = 256
    pages: Optional[int] = None
    page_size: int = 16
    preemption: str = "on"              # on|off|recompute|swap|auto
    host_pages: Optional[int] = None
    host_bw: Optional[float] = None     # GB/s, simulator only
    swap_serial: bool = False
    swap_in_budget: Optional[int] = None
    decode_reserve: Optional[int] = None
    packed: bool = True
    # prefix cache
    prefix_cache: bool = True
    prefix_lru_pages: Optional[int] = None
    # disaggregated prefill/decode pools
    disagg: bool = False
    handoff: str = "stream"             # stream | whole
    decode_pages: Optional[int] = None
    decode_watermark: int = 0
    # MoE / speculation
    moe_dispatch: str = "ragged"
    spec: str = "off"                   # off|ngram|draft
    spec_k: int = 4
    draft_config: Optional[str] = None
    spec_acceptance: float = 0.7
    # hardware / SLO
    hw: str = "h100x2"
    ttft_slo: float = 10.0
    tbt_slo: float = 0.125
    # HTTP front-end
    http: Optional[str] = None          # "host:port" or ":port"
    queue_watermark: int = 64
    pool_watermark: float = 0.125
    ratelimit_rate: Optional[float] = None
    ratelimit_burst: float = 8.0
    keepalive_timeout: float = 5.0
    # fault tolerance / chaos (serving/faults.py)
    fault_plan: Optional[str] = None    # "@file.json" | "seed:N" | inline JSON
    deadline_ms: Optional[float] = None
    drain_timeout: float = 10.0
    retry_budget: int = 3
    # the port's own: dtype override (None: the config's own), device
    # (None: cuda), and the closed loop's prompt and new-token ranges
    # [lo, hi) (None: the JAX launcher's (16, max_len // 2) and (4, 16))
    dtype: Optional[str] = None
    device: Optional[str] = None
    prompt_len: Optional[Tuple[int, int]] = None
    new_tokens: Optional[Tuple[int, int]] = None

    # ------------------------------------------------------------ validation

    def validate(self) -> "ServeConfig":
        choices = {
            "arch": tuple(list_configs()),
            "scheduler": tuple(sorted(SCHEDULERS)),
            "clock": ("virtual", "wall"),
            "dataset": tuple(DATASETS),
            "arrival": tuple(sorted(ARRIVAL_PROCESSES)),
            "preemption": ("on", "off", "recompute", "swap", "auto"),
            "moe_dispatch": ("ragged", "dense"),
            "spec": ("off", "ngram", "draft"),
            "hw": ("h100x2", "tpu_v5e"),
            "dtype": (None, "float32", "bfloat16"),
            "handoff": ("stream", "whole"),
        }
        for name, opts in choices.items():
            if getattr(self, name) not in opts:
                raise ValueError(f"{name}={getattr(self, name)!r} "
                                 f"not one of {opts}")
        positive = ["rate", "requests", "slots", "quantum", "token_budget",
                    "max_len", "page_size", "spec_k", "ttft_slo",
                    "tbt_slo", "queue_watermark", "ratelimit_burst",
                    "keepalive_timeout", "drain_timeout"]
        for name in positive:
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive "
                                 f"(got {getattr(self, name)})")
        for name in ("pages", "host_pages", "swap_in_budget",
                     "prefix_lru_pages", "host_bw", "ratelimit_rate",
                     "decode_pages", "deadline_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be positive or None "
                                 f"(got {v})")
        for name in ("batch_fraction", "pool_watermark"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1] (got {v})")
        if not 0.0 < self.spec_acceptance <= 1.0:
            raise ValueError(f"spec_acceptance must be in (0, 1] "
                             f"(got {self.spec_acceptance})")
        if self.class_headroom < 0 or self.decode_reserve is not None \
                and self.decode_reserve < 0:
            raise ValueError("class_headroom/decode_reserve must be >= 0")
        if self.decode_watermark < 0:
            raise ValueError(f"decode_watermark must be >= 0 "
                             f"(got {self.decode_watermark})")
        if self.retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0 "
                             f"(got {self.retry_budget})")
        if self.disagg and self.http is not None:
            raise ValueError("--disagg runs the two-pool trace loops; "
                             "it cannot be combined with --http")
        if self.spec == "draft" and not self.draft_config:
            raise ValueError("spec='draft' needs draft_config")
        if self.spec != "off" and self.recurrent_mixers():
            raise ValueError(
                f"spec={self.spec!r}: {self.arch} has recurrent mixers "
                f"{list(self.recurrent_mixers())} whose state cannot be "
                "rolled back past rejected drafts")
        if self.http is not None:
            self.http_endpoint()        # raises on malformed host:port
        if self.simulate and self.http is not None:
            raise ValueError("--http serves the real engine; "
                             "it cannot be combined with --simulate")
        for name in ("prompt_len", "new_tokens"):
            v = getattr(self, name)
            if v is not None and not 0 < v[0] < v[1]:
                raise ValueError(f"{name} must be a range 0 < lo < hi "
                                 f"(got {v})")
        return self

    # ---------------------------------------------------------- persistence

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2,
                          sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ServeConfig":
        d = json.loads(text)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ServeConfig fields: "
                             f"{sorted(unknown)}")
        return cls(**_ranges_as_tuples(d)).validate()

    # -------------------------------------------------------------- argparse

    @staticmethod
    def add_arguments(ap: argparse.ArgumentParser) -> None:
        """THE flag definition — serve.py and load_gen share it verbatim."""
        d = ServeConfig()
        ap.add_argument("--arch", default=d.arch, choices=list_configs())
        ap.add_argument("--scheduler", default=d.scheduler,
                        choices=sorted(SCHEDULERS))
        ap.add_argument("--smoke", action="store_true",
                        help="run the reduced variant of the config")
        ap.add_argument("--simulate", action="store_true",
                        help="the discrete-event simulator at the "
                             "config's full scale (analytic cost model, "
                             "no device) instead of the engine")
        ap.add_argument("--open-loop", action="store_true",
                        help="replay a timed trace (requests injected at "
                             "their arrival times) instead of the "
                             "closed-loop submit-everything drain")
        ap.add_argument("--clock", default=d.clock,
                        choices=["virtual", "wall"],
                        help="open-loop clock: virtual (1 unit per "
                             "iteration, deterministic) or wall (arrival "
                             "times in real seconds; idles really sleep)")
        ap.add_argument("--stream", action="store_true",
                        help="print every generated token as it is emitted")
        ap.add_argument("--dataset", default=d.dataset,
                        choices=list(DATASETS),
                        help="simulator: the trace's length model")
        ap.add_argument("--arrival", default=d.arrival,
                        choices=sorted(ARRIVAL_PROCESSES),
                        help="arrival process (bursty = on/off modulated "
                             "Poisson with the same long-run rate)")
        ap.add_argument("--rate", type=float, default=d.rate)
        ap.add_argument("--requests", type=int, default=d.requests)
        ap.add_argument("--batch-fraction", type=float,
                        default=d.batch_fraction,
                        help="open loop: fraction of requests tagged "
                             "slo_class=batch (evicted before interactive "
                             "under memory pressure)")
        ap.add_argument("--class-headroom", type=int,
                        default=d.class_headroom,
                        help="pages reserved for interactive admissions")
        ap.add_argument("--slots", type=int, default=d.slots)
        ap.add_argument("--quantum", type=int, default=d.quantum)
        ap.add_argument("--token-budget", type=int, default=d.token_budget)
        ap.add_argument("--max-len", type=int, default=d.max_len)
        ap.add_argument("--pages", type=int, default=d.pages,
                        help="paged KV pool size in pages (default: every "
                             "slot row fits)")
        ap.add_argument("--page-size", type=int, default=d.page_size,
                        help="KV tokens per page")
        ap.add_argument("--preemption", default=d.preemption,
                        choices=["on", "off", "recompute", "swap", "auto"],
                        help="memory-pressure eviction mode: recompute "
                             "(= on), swap (KV rows to pinned host memory, "
                             "copied back on swap-in), auto (per-victim "
                             "choice), off (queueing-only admission)")
        ap.add_argument("--host-pages", type=int, default=d.host_pages,
                        help="host-side swap pool size in pages (default: "
                             "4x the device pool when swap/auto)")
        ap.add_argument("--host-bw", type=float, default=d.host_bw,
                        help="host<->HBM DMA bandwidth in GB/s "
                             "(simulator only)")
        ap.add_argument("--swap-serial", action="store_true",
                        help="charge swap DMA as a fully serial stall "
                             "(simulator only)")
        ap.add_argument("--swap-in-budget", type=int,
                        default=d.swap_in_budget,
                        help="max KV tokens copied back from host per "
                             "iteration (default: unlimited)")
        ap.add_argument("--decode-reserve", type=int,
                        default=d.decode_reserve,
                        help="per-request decode KV reservation in tokens "
                             "(default: one page)")
        ap.add_argument("--packed", default=d.packed,
                        action=argparse.BooleanOptionalAction,
                        help="packed layer-group execution (one batch per "
                             "layer-group rectangle); --no-packed launches "
                             "each prefill slice on its own")
        ap.add_argument("--prefix-cache", default=d.prefix_cache,
                        action=argparse.BooleanOptionalAction,
                        help="automatic prefix caching over a refcounted "
                             "content-hash page index; --no-prefix-cache "
                             "restores cold prefill")
        ap.add_argument("--prefix-lru-pages", type=int,
                        default=d.prefix_lru_pages,
                        help="cap on retained refcount-0 cached pages "
                             "(default: unbounded)")
        ap.add_argument("--disagg", action="store_true",
                        help="disaggregated serving: a prefill pool and a "
                             "decode pool under one clock, over one copy "
                             "of the weights, with KV handed off through "
                             "pinned host memory")
        ap.add_argument("--handoff", default=d.handoff,
                        choices=["stream", "whole"],
                        help="KV handoff granularity: stream each layer "
                             "group's KV as its prefill completes, or copy "
                             "the whole prompt after the last group")
        ap.add_argument("--decode-pages", type=int, default=d.decode_pages,
                        help="decode-pool KV pages (default: same as the "
                             "prefill pool)")
        ap.add_argument("--decode-watermark", type=int,
                        default=d.decode_watermark,
                        help="hold new arrivals while decode-pool free "
                             "pages are below this watermark")
        ap.add_argument("--moe-dispatch", default=d.moe_dispatch,
                        choices=["ragged", "dense"],
                        help="dropless MoE data path")
        ap.add_argument("--spec", default=d.spec,
                        choices=["off", "ngram", "draft"],
                        help="speculative verify-k decoding; greedy "
                             "output streams are spec off's (in bf16 "
                             "they may part at near-ties)")
        ap.add_argument("--spec-k", type=int, default=d.spec_k,
                        help="max drafted tokens verified per request "
                             "per iteration")
        ap.add_argument("--draft-config", default=d.draft_config,
                        help="config whose smoke variant drafts for "
                             "--spec draft")
        ap.add_argument("--spec-acceptance", type=float,
                        default=d.spec_acceptance,
                        help="simulator only: per-token draft acceptance "
                             "probability")
        ap.add_argument("--hw", default=d.hw,
                        choices=["h100x2", "tpu_v5e"],
                        help="simulator: the hardware preset the cost "
                             "model prices (model inputs, not "
                             "measurements)")
        ap.add_argument("--ttft-slo", type=float, default=d.ttft_slo)
        ap.add_argument("--tbt-slo", type=float, default=d.tbt_slo)
        ap.add_argument("--seed", type=int, default=d.seed)
        ap.add_argument("--http", default=d.http, metavar="HOST:PORT",
                        help="serve the engine over HTTP/SSE on this "
                             "endpoint (e.g. :8000 or 127.0.0.1:8000) "
                             "instead of running a trace")
        ap.add_argument("--queue-watermark", type=int,
                        default=d.queue_watermark,
                        help="HTTP backpressure: queue depth at which "
                             "(with the pool watermark) admission "
                             "answers 429")
        ap.add_argument("--pool-watermark", type=float,
                        default=d.pool_watermark,
                        help="HTTP backpressure: free-page fraction at "
                             "or below which (with the queue watermark) "
                             "admission answers 429")
        ap.add_argument("--ratelimit-rate", type=float,
                        default=d.ratelimit_rate,
                        help="per-tenant token-bucket refill rate in "
                             "requests/s (default: rate limiting off)")
        ap.add_argument("--ratelimit-burst", type=float,
                        default=d.ratelimit_burst,
                        help="per-tenant token-bucket burst capacity")
        ap.add_argument("--keepalive-timeout", type=float,
                        default=d.keepalive_timeout,
                        help="seconds an idle keep-alive connection is "
                             "held open before the server closes it")
        ap.add_argument("--fault-plan", default=d.fault_plan,
                        help="chaos mode: a FaultPlan spec — '@plan.json' "
                             "loads a file, 'seed:N' draws a deterministic "
                             "random schedule, anything else parses as "
                             "inline JSON (default: no fault injection)")
        ap.add_argument("--retry-budget", type=int, default=d.retry_budget,
                        help="fault recoveries (crash/link-drop "
                             "recomputes) per request before it is shed")
        ap.add_argument("--deadline-ms", type=float, default=d.deadline_ms,
                        help="default per-request completion deadline; "
                             "expired requests are shed and their KV "
                             "freed (wall clocks: ms; virtual clocks: "
                             "clock units; default: no deadline)")
        ap.add_argument("--drain-timeout", type=float,
                        default=d.drain_timeout,
                        help="graceful-drain bound: seconds the HTTP "
                             "server waits for in-flight streams before "
                             "cancelling them on shutdown")
        ap.add_argument("--dtype", default=None,
                        choices=["float32", "bfloat16"],
                        help="override the config's activation/param dtype")
        ap.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
        ap.add_argument("--prompt-len", type=int, nargs=2,
                        default=d.prompt_len, metavar=("LO", "HI"),
                        help="closed loop: prompt lengths in [LO, HI) "
                             "(default: [16, max_len // 2))")
        ap.add_argument("--new-tokens", type=int, nargs=2,
                        default=d.new_tokens, metavar=("LO", "HI"),
                        help="closed loop: new tokens per request in "
                             "[LO, HI) (default: [4, 16))")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServeConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**_ranges_as_tuples(
            {k: v for k, v in vars(args).items() if k in known})).validate()

    # ------------------------------------------------------- derived kwargs

    def preemption_opts(self) -> Tuple[bool, str]:
        """(enabled, mode): "on" is an alias for "recompute"; "off"
        disables eviction entirely (queueing-only admission)."""
        enabled = self.preemption != "off"
        mode = self.preemption if self.preemption in ("swap", "auto") \
            else "recompute"
        return enabled, mode

    def recurrent_mixers(self) -> Tuple[str, ...]:
        """The recurrent mixer kinds of ``arch``'s stack (none for an
        attention-only stack)."""
        return tuple(sorted({sp.mixer for sp in
                             get_config(self.arch).block_specs()
                             if sp.is_recurrent()}))

    def prefix_cache_on(self) -> bool:
        """``prefix_cache``, except on a stack with recurrent mixers: the
        engine refuses the prefix cache there (their state has no
        position axis to restore at a page boundary), so such an arch is
        served with it off."""
        return self.prefix_cache and not self.recurrent_mixers()

    def class_headroom_opt(self) -> Optional[Dict[str, int]]:
        return {"interactive": self.class_headroom} \
            if self.class_headroom else None

    def scheduler_kwargs(self) -> Dict:
        return dict(n_slots=self.slots, quantum=self.quantum,
                    token_budget=self.token_budget)

    def engine_kwargs(self) -> Dict:
        """Engine(...) keyword arguments (model/params/scheduler are the
        caller's three positionals)."""
        enabled, mode = self.preemption_opts()
        return dict(n_slots=self.slots, max_len=self.max_len,
                    moe_dispatch=self.moe_dispatch,
                    pages=self.pages, page_size=self.page_size,
                    preemption=enabled, preemption_mode=mode,
                    host_pages=self.host_pages,
                    swap_in_budget=self.swap_in_budget,
                    decode_reserve=self.decode_reserve,
                    class_headroom=self.class_headroom_opt(),
                    prefix_cache=self.prefix_cache_on(),
                    prefix_lru_pages=self.prefix_lru_pages,
                    packed=self.packed,
                    spec_mode=self.spec, spec_k=self.spec_k,
                    draft_config=self.draft_config)

    def sim_kwargs(self) -> Dict:
        """Simulator(...) keyword arguments (cfg/scheduler/hw are the
        caller's three positionals)."""
        enabled, mode = self.preemption_opts()
        return dict(n_slots=self.slots, quantum=self.quantum,
                    token_budget=self.token_budget,
                    moe_dispatch=self.moe_dispatch,
                    n_pages=self.pages, page_size=self.page_size,
                    preemption=enabled, preemption_mode=mode,
                    host_pages=self.host_pages,
                    swap_in_budget=self.swap_in_budget,
                    decode_reserve=self.decode_reserve,
                    swap_overlap=not self.swap_serial,
                    class_headroom=self.class_headroom_opt(),
                    prefix_cache=self.prefix_cache_on(),
                    prefix_lru_pages=self.prefix_lru_pages,
                    spec_mode=self.spec, spec_k=self.spec_k,
                    spec_acceptance=self.spec_acceptance)

    def http_endpoint(self) -> Tuple[str, int]:
        """Parse --http "host:port" (":8000" binds 127.0.0.1; port 0 asks
        the OS for a free port)."""
        if self.http is None:
            raise ValueError("http endpoint not configured")
        host, _, port = self.http.rpartition(":")
        try:
            return host or "127.0.0.1", int(port)
        except ValueError:
            raise ValueError(f"--http must be HOST:PORT or :PORT "
                             f"(got {self.http!r})") from None

    def server_kwargs(self) -> Dict:
        """ServingServer(...) keyword arguments (engine is positional)."""
        host, port = self.http_endpoint()
        return dict(host=host, port=port,
                    ratelimit_rate=self.ratelimit_rate,
                    ratelimit_burst=self.ratelimit_burst,
                    queue_watermark=self.queue_watermark,
                    pool_watermark=self.pool_watermark,
                    keepalive_timeout=self.keepalive_timeout,
                    deadline_ms=self.deadline_ms,
                    drain_timeout=self.drain_timeout,
                    retry_budget=self.retry_budget,
                    slo=self.slo())

    def slo(self) -> SLOConfig:
        return SLOConfig(self.ttft_slo, self.tbt_slo)

    # ---------------------------------------------------------- open loop

    def engine_trace(self, vocab_size: int):
        """Open-loop trace for the engine, built with the traffic module's
        generators (``arrival`` selects the process, ``batch_fraction`` the
        class mix) with a length model shrunk to the engine's max_len, and
        real token ids attached for replay.  ``rate`` is requests per unit
        of the selected clock."""
        smoke = DatasetModel(
            name="engine-smoke",
            input_len=LengthModel(mean=self.max_len // 6,
                                  std=self.max_len // 8,
                                  lo=16, hi=self.max_len // 2),
            output_len=LengthModel(mean=9, std=4, lo=4, hi=15))
        n_batch = int(round(self.requests * self.batch_fraction))
        specs = [ClassSpec("batch", smoke,
                           self.rate * self.batch_fraction,
                           n_batch, process=self.arrival)] if n_batch \
            else []
        if self.requests - n_batch:
            specs.append(ClassSpec(
                "interactive", smoke,
                self.rate * (1 - self.batch_fraction),
                self.requests - n_batch,
                process=self.arrival if not n_batch else "poisson"))
        trace = multi_class_trace(specs, seed=self.seed)
        return attach_prompt_tokens(trace, vocab_size, seed=self.seed)


def _ranges_as_tuples(d: Dict) -> Dict:
    """``prompt_len``/``new_tokens`` as tuples (argparse and JSON give
    lists), so that configs compare equal whatever their source."""
    return {k: tuple(v) if k in ("prompt_len", "new_tokens")
            and v is not None else v for k, v in d.items()}
