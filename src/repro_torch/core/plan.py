"""Scheduling primitives shared by every scheduler, the engine and the
discrete-event simulator.

The central abstraction generalizing chunked *and* layered prefill is the
2-D **PrefillSlice** — a rectangle (token range × block range) of one
request's prefill work:

  - chunked prefill  : (chunk_i tokens,            ALL blocks)
  - layered prefill  : (ALL tokens,                group_g blocks)
  - hybrid (§4.3)    : (chunk_i tokens,            group_g blocks)
  - continuous (Orca): (ALL tokens,                ALL blocks)

An ``IterationPlan`` is what a scheduler emits per engine iteration: the
decode batch (every request in DECODE state — stall-freeness is precisely
the property that this list is never preempted) plus the prefill slices
co-scheduled with it.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    # victim of a memory-pressure eviction, queued for restore-by-recompute:
    # its pages are freed, its generated tokens are folded into the
    # recompute prompt, and it re-enters PREFILL at the head of the queue
    PREEMPTED = "preempted"
    # victim of a memory-pressure eviction under swap mode: its KV pages
    # moved to the host pool intact; re-admission DMAs them back (gated on
    # free HBM pages AND the per-iteration swap-in bandwidth budget) and the
    # request resumes DECODE directly — no recompute epoch
    SWAPPED = "swapped"
    DONE = "done"


@dataclass(frozen=True)
class SubmitSpec:
    """THE request-ingestion record.  Every path that creates a serving
    request — HTTP POST /v1/generate, open-loop trace replay, closed-loop
    benchmark drains, the load generator — builds one of these and hands
    it to ``Executor.submit`` / ``Engine.submit_spec``; there is no other
    door.  Frozen so a spec can sit in a cross-thread queue, be retried
    after a 429, or be replayed offline without aliasing surprises.

    ``prompt_tokens`` carries real token ids (required by the engine;
    analytic backends may run from ``prompt_len`` alone).  ``arrival_time``
    is the trace timestamp for replay; None means "stamp me when the
    serving loop first sees me" — the live-traffic case.  ``tenant`` is
    the rate-limiting identity used by the HTTP front-end (per-tenant
    token buckets); it defaults to the SLO class when unset so single-
    tenant setups need no extra field."""
    max_new_tokens: int
    prompt_tokens: Optional[Tuple[int, ...]] = None
    prompt_len: Optional[int] = None
    slo_class: str = "interactive"
    arrival_time: Optional[float] = None
    tenant: Optional[str] = None
    # engine-only extras: encoder frames for enc-dec models (kept opaque
    # here — the engine validates shape), opt-outs for the shared-prefix
    # cache and speculative decoding on a per-request basis
    enc_frames: Optional[object] = None
    prefix_cache: bool = True
    speculative: bool = True
    # per-request completion deadline: the serving runtime sheds the
    # request (freeing ALL its KV) once arrival_time + deadline elapses.
    # Interpreted against the runtime's clock — wall-clock executors read
    # it as milliseconds, the deterministic iteration clock as iterations.
    # None disables shedding for this request.
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.prompt_tokens is None and self.prompt_len is None:
            raise ValueError(
                "SubmitSpec needs prompt_tokens (engine) or prompt_len "
                "(analytic backends)")
        if self.prompt_tokens is not None:
            toks = tuple(int(t) for t in self.prompt_tokens)
            object.__setattr__(self, "prompt_tokens", toks)
            if self.prompt_len is None:
                object.__setattr__(self, "prompt_len", len(toks))
            elif self.prompt_len != len(toks):
                raise ValueError(
                    f"prompt_len {self.prompt_len} != "
                    f"len(prompt_tokens) {len(toks)}")
        if self.prompt_len <= 0:
            raise ValueError(f"prompt_len must be positive, "
                             f"got {self.prompt_len}")
        if self.max_new_tokens <= 0:
            raise ValueError(f"max_new_tokens must be positive, "
                             f"got {self.max_new_tokens}")
        if self.tenant is None:
            object.__setattr__(self, "tenant", self.slo_class)
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be positive or None, "
                             f"got {self.deadline_ms}")


@dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    arrival_time: float = 0.0
    # multi-tenant SLO class ("interactive" | "batch" | operator-defined):
    # drives class-aware eviction ordering (batch victims go first) and the
    # optional per-class admission headroom — see core/base.py
    slo_class: str = "interactive"
    # engine-only: actual token ids (None in the simulator)
    prompt_tokens: Optional[object] = None
    # rate-limiting identity (SubmitSpec.tenant); per-request opt-outs for
    # the shared-prefix cache (neither match nor publish) and speculative
    # decoding (never drafted for) — SubmitSpec carries both end to end
    tenant: str = "interactive"
    use_prefix_cache: bool = True
    use_speculation: bool = True
    # completion deadline relative to arrival (SubmitSpec.deadline_ms);
    # enforced by the serving runtime's shed scan, None = no deadline
    deadline_ms: Optional[float] = None
    state: RequestState = RequestState.WAITING
    # prefill progress. After a preemption, prompt_len is the RECOMPUTE
    # length (original prompt + tokens generated before eviction) and these
    # counters restart from zero for the new prefill epoch.
    tokens_done: int = 0            # prompt tokens fully processed (all blocks)
    blocks_done: int = 0            # blocks processed for the current chunk
    n_generated: int = 0
    n_preemptions: int = 0
    n_folded: int = 0               # generated tokens folded into prompt_len
    orig_prompt_len: Optional[int] = None   # set on first preemption
    # swap-to-host eviction bookkeeping (paired out/in timestamps; a request
    # still swapped out has one more out than in)
    n_swaps: int = 0
    swap_out_times: List[float] = field(default_factory=list)
    swap_in_times: List[float] = field(default_factory=list)
    # speculative decoding bookkeeping (commit_speculation): rounds in which
    # the executor actually proposed draft tokens, totals over proposed /
    # accepted drafts, and the per-round accepted lengths (for p50/p90)
    n_spec_rounds: int = 0
    n_drafted: int = 0
    n_draft_accepted: int = 0
    accepted_lens: List[int] = field(default_factory=list)
    # automatic prefix caching (cumulative over all admissions, including
    # recompute epochs): prompt tokens served from shared KV pages vs
    # prompt tokens this request would have prefilled cold
    cached_prompt_tokens: int = 0
    admitted_prompt_tokens: int = 0
    # disaggregated prefill→decode handoff bookkeeping (cumulative over
    # migrations — a recompute victim routed back to the prefill pool
    # migrates again): streamed layer-group chunks, tokens whose payload
    # crossed the inter-pool link vs tokens linked to pages already warm
    # on the decode pool, and the migration completion timestamp
    n_handoffs: int = 0
    n_handoff_chunks: int = 0
    handoff_moved_tokens: int = 0
    handoff_linked_tokens: int = 0
    handoff_time: Optional[float] = None
    # fault-tolerance bookkeeping (serving/faults.py): recoveries consumed
    # from the runtime's retry budget, and — for requests removed without
    # completing — why ("deadline" | "retries" | "disconnect" | "degrade");
    # shed_reason None on a DONE request means it finished normally
    n_fault_retries: int = 0
    shed_reason: Optional[str] = None
    # metrics (filled by engine/simulator)
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def remaining_prompt(self) -> int:
        return self.prompt_len - self.tokens_done

    @property
    def cacheable_prompt(self) -> Optional[object]:
        """Prompt tokens as seen by the shared-prefix machinery: None when
        this request opted out, so every lookup/register site uniformly
        sees a miss without sprinkling flag checks."""
        return self.prompt_tokens if self.use_prefix_cache else None

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of this request's admitted prompt tokens served from
        the shared prefix cache (0.0 before first admission)."""
        return self.cached_prompt_tokens / max(self.admitted_prompt_tokens, 1)

    @classmethod
    def from_spec(cls, spec: "SubmitSpec", req_id: int, *,
                  arrival_time: float,
                  prompt_tokens: Optional[object] = None) -> "Request":
        """Build the mutable serving Request from an ingestion spec — the
        one place spec fields map onto request fields, shared by the
        engine and the analytic backends.  ``prompt_tokens`` lets the
        caller pass its backend-native array form (the engine's int32
        ndarray); defaults to the spec's tuple."""
        return cls(req_id=req_id, prompt_len=spec.prompt_len,
                   max_new_tokens=spec.max_new_tokens,
                   arrival_time=arrival_time,
                   slo_class=spec.slo_class,
                   prompt_tokens=spec.prompt_tokens
                   if prompt_tokens is None else prompt_tokens,
                   tenant=spec.tenant,
                   use_prefix_cache=spec.prefix_cache,
                   use_speculation=spec.speculative,
                   deadline_ms=spec.deadline_ms)

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def queue_delay(self) -> Optional[float]:
        """Time spent queued before FIRST admission (memory-gated admission
        makes this a first-class serving metric)."""
        if self.admit_time is None:
            return None
        return self.admit_time - self.arrival_time

    def tbts(self) -> List[float]:
        ts = [self.first_token_time] + self.token_times \
            if self.first_token_time is not None else self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    def restore_latencies(self) -> List[float]:
        """Per completed swap cycle: time spent swapped out on host (swap-out
        to swap-in).  An in-flight swap (out without in yet) is excluded."""
        return [b - a for a, b in zip(self.swap_out_times,
                                      self.swap_in_times)]


@dataclass(frozen=True)
class PrefillSlice:
    req_id: int
    token_start: int
    token_end: int
    block_start: int
    block_end: int
    emits_first_token: bool = False   # last slice of the request's prefill

    @property
    def n_tokens(self) -> int:
        return self.token_end - self.token_start

    @property
    def n_blocks(self) -> int:
        return self.block_end - self.block_start


@dataclass
class IterationPlan:
    decode_ids: List[int] = field(default_factory=list)
    prefill: List[PrefillSlice] = field(default_factory=list)
    admitted_ids: List[int] = field(default_factory=list)
    # memory-pressure victims evicted THIS iteration (latest-arrival-first);
    # the executor frees their slot/stash state before running the plan.
    # preempted_ids = fold-to-recompute victims; swapped_out_ids = victims
    # whose KV moved to the host pool intact (SWAPPED state)
    preempted_ids: List[int] = field(default_factory=list)
    swapped_out_ids: List[int] = field(default_factory=list)
    # swapped requests restored THIS iteration (DMA-back); they are already
    # in DECODE state and appear in decode_ids — the executor must copy
    # their host KV back into device cache before the decode step
    swapped_in_ids: List[int] = field(default_factory=list)
    # speculative decoding: req_id -> draft budget k for this iteration.
    # The executor verifies up to k proposed tokens per listed request in
    # one dispatch and MUST call scheduler.commit_speculation for every
    # listed id afterwards (even with 0 proposals) so the speculative page
    # reservation is released.  Requests absent from this dict decode one
    # token exactly as before — an empty dict is the non-speculative plan.
    verify_len: Dict[int, int] = field(default_factory=dict)

    @property
    def empty(self) -> bool:
        return not self.decode_ids and not self.prefill
