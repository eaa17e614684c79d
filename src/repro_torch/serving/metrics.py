"""Serving metrics: TTFT / TBT statistics, per-request SLO attainment
(paper §5.1: a request attains the SLO iff its TTFT meets the TTFT SLO AND
every TBT meets the TBT SLO), per-SLO-class breakdowns for the
multi-tenant sweeps, energy-per-token accounting, and the paged-KV
memory-subsystem signals (queueing delay under memory-gated admission,
preemption rate, page high-water)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.core.plan import Request


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default "linear" method).
    The old nearest-rank-via-round variant biased p99 on small samples —
    on 10 points it returned the maximum for every q above ~94."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = min(max(q, 0.0), 100.0) / 100.0 * (len(s) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclass(frozen=True)
class SLOConfig:
    ttft_slo: float            # seconds
    tbt_slo: float             # seconds

    def attained(self, req: Request) -> bool:
        t = req.ttft()
        if t is None or t > self.ttft_slo:
            return False
        return all(b <= self.tbt_slo for b in req.tbts())


def request_metrics(requests: Iterable[Request],
                    slo: Optional[SLOConfig] = None) -> Dict[str, float]:
    reqs = [r for r in requests if r.first_token_time is not None]
    ttfts = [r.ttft() for r in reqs]
    tbts: List[float] = []
    for r in reqs:
        tbts.extend(r.tbts())
    out = {
        "n_requests": float(len(reqs)),
        "ttft_mean": sum(ttfts) / len(ttfts) if ttfts else float("nan"),
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p90": percentile(ttfts, 90),
        "ttft_p99": percentile(ttfts, 99),
        "tbt_mean": sum(tbts) / len(tbts) if tbts else float("nan"),
        "tbt_p50": percentile(tbts, 50),
        "tbt_p90": percentile(tbts, 90),
        "tbt_p99": percentile(tbts, 99),
    }
    e2e = [r.finish_time - r.arrival_time for r in reqs
           if r.finish_time is not None]
    out["e2e_mean"] = sum(e2e) / len(e2e) if e2e else float("nan")
    # memory-gated admission: time queued before FIRST admission
    delays = [d for d in (r.queue_delay() for r in reqs) if d is not None]
    out["queue_delay_mean"] = sum(delays) / len(delays) if delays \
        else float("nan")
    out["queue_delay_p99"] = percentile(delays, 99)
    n_pre = sum(r.n_preemptions for r in reqs)
    out["n_preemptions"] = float(n_pre)
    out["preemption_rate"] = n_pre / len(reqs) if reqs else float("nan")
    # swap-to-host eviction: swap counts and the time victims sat on host
    # (swap-out -> swap-in) — the latency cost of the DMA restore path
    n_swaps = sum(r.n_swaps for r in reqs)
    out["n_swaps"] = float(n_swaps)
    out["swap_rate"] = n_swaps / len(reqs) if reqs else float("nan")
    restores: List[float] = []
    for r in reqs:
        restores.extend(r.restore_latencies())
    out["restore_latency_mean"] = sum(restores) / len(restores) \
        if restores else float("nan")
    out["restore_latency_p99"] = percentile(restores, 99)
    # speculative decode: acceptance rate over all drafted tokens, and the
    # distribution of per-round accepted prefix lengths (0 when a round's
    # first draft already missed)
    n_drafted = sum(r.n_drafted for r in reqs)
    n_accepted = sum(r.n_draft_accepted for r in reqs)
    out["spec_drafted"] = float(n_drafted)
    out["spec_acceptance_rate"] = n_accepted / n_drafted if n_drafted \
        else float("nan")
    acc_lens: List[float] = []
    for r in reqs:
        acc_lens.extend(float(a) for a in r.accepted_lens)
    out["accepted_len_p50"] = percentile(acc_lens, 50)
    out["accepted_len_p90"] = percentile(acc_lens, 90)
    # automatic prefix caching: token-weighted hit rate (cached prompt
    # tokens over all admitted prompt tokens, recompute re-admissions
    # included) and the mean cached tokens per request
    cached = sum(r.cached_prompt_tokens for r in reqs)
    admitted = sum(r.admitted_prompt_tokens for r in reqs)
    out["prefix_hit_rate"] = cached / admitted if admitted else 0.0
    out["cached_prompt_tokens"] = cached / len(reqs) if reqs \
        else float("nan")
    # disaggregated prefill->decode handoff: migration counts, streamed
    # layer-group chunks, and the linked/moved token split (tokens linked
    # to pages already warm on the decode pool crossed the link for free
    # — the KV-locality routing win).  All zero under monolithic serving.
    n_handoffs = sum(r.n_handoffs for r in reqs)
    moved = sum(r.handoff_moved_tokens for r in reqs)
    linked = sum(r.handoff_linked_tokens for r in reqs)
    out["n_handoffs"] = float(n_handoffs)
    out["handoff_chunks_mean"] = sum(r.n_handoff_chunks for r in reqs) \
        / n_handoffs if n_handoffs else float("nan")
    out["handoff_moved_tokens"] = float(moved)
    out["handoff_linked_tokens"] = float(linked)
    out["handoff_link_ratio"] = linked / (linked + moved) \
        if linked + moved else float("nan")
    if slo is not None:
        att = [slo.attained(r) for r in reqs]
        out["slo_attainment"] = sum(att) / len(att) if att else float("nan")
        t_ok = [r.ttft() <= slo.ttft_slo for r in reqs]
        b_ok = [all(b <= slo.tbt_slo for b in r.tbts()) for r in reqs]
        out["ttft_attainment"] = sum(t_ok) / len(t_ok) if t_ok else float("nan")
        out["tbt_attainment"] = sum(b_ok) / len(b_ok) if b_ok else float("nan")
    return out


def per_class_metrics(
        requests: Iterable[Request],
        slo: Union[SLOConfig, Dict[str, SLOConfig], None] = None,
) -> Dict[str, Dict[str, float]]:
    """Split ``request_metrics`` by SLO class (the multi-tenant breakdown:
    per-class TTFT/TBT/attainment/preemption/swap).  ``slo`` may be one
    config applied to every class, a per-class dict (classes missing from
    it get no attainment columns), or None."""
    reqs = list(requests)
    out: Dict[str, Dict[str, float]] = {}
    for cls in sorted({r.slo_class for r in reqs}):
        cls_slo = slo.get(cls) if isinstance(slo, dict) else slo
        out[cls] = request_metrics(
            [r for r in reqs if r.slo_class == cls], cls_slo)
    return out


def handoff_counters(*, handoff_bytes: float = 0.0, queue_depth: int = 0,
                     link_stall_time: float = 0.0,
                     handoff_wait_time: float = 0.0,
                     n_migrations: int = 0,
                     n_returns: int = 0) -> Dict[str, float]:
    """THE canonical names for the disaggregated-handoff counters, shared
    by the live ``/metrics`` scrape (via ``prometheus_text(counters=...)``)
    and the offline benchmark reports, so the two can never disagree on
    spelling or units.  ``queue_depth`` is instantaneous (migrations
    exported but not yet imported); the rest are run totals."""
    return {
        "handoff_bytes_total": float(handoff_bytes),
        "handoff_queue_depth": float(queue_depth),
        "handoff_link_stall_seconds_total": float(link_stall_time),
        "handoff_wait_seconds_total": float(handoff_wait_time),
        "handoff_migrations_total": float(n_migrations),
        "handoff_returns_total": float(n_returns),
    }


def fault_counters(*, n_injected_faults: float = 0.0,
                   n_executor_crashes: float = 0.0,
                   n_link_drops: float = 0.0,
                   n_link_delays: float = 0.0,
                   n_swap_dma_fails: float = 0.0,
                   n_pressure_spikes: float = 0.0,
                   n_injected_disconnects: float = 0.0,
                   n_deadline_sheds: float = 0.0,
                   n_retry_sheds: float = 0.0,
                   n_disconnect_sheds: float = 0.0,
                   n_degrade_sheds: float = 0.0,
                   n_fault_retries: float = 0.0,
                   degradation_level: float = 0.0,
                   n_degradation_escalations: float = 0.0,
                   n_degradation_deescalations: float = 0.0,
                   ) -> Dict[str, float]:
    """THE canonical names for the fault-tolerance counters — shaped so
    ``fault_counters(**runtime.fault_stats())`` is the whole call.  Same
    contract as ``handoff_counters``: the live ``/metrics`` scrape and
    offline chaos reports share one spelling.  All ``*_total`` names are
    run totals; ``degradation_level`` is the instantaneous ladder rung
    index (0 = normal .. 4 = interactive_503)."""
    return {
        "faults_injected_total": float(n_injected_faults),
        "fault_executor_crashes_total": float(n_executor_crashes),
        "fault_link_drops_total": float(n_link_drops),
        "fault_link_delays_total": float(n_link_delays),
        "fault_swap_dma_fails_total": float(n_swap_dma_fails),
        "fault_pressure_spikes_total": float(n_pressure_spikes),
        "fault_injected_disconnects_total": float(n_injected_disconnects),
        "sheds_deadline_total": float(n_deadline_sheds),
        "sheds_retries_total": float(n_retry_sheds),
        "sheds_disconnect_total": float(n_disconnect_sheds),
        "sheds_degrade_total": float(n_degrade_sheds),
        "fault_retries_total": float(n_fault_retries),
        "degradation_level": float(degradation_level),
        "degradation_escalations_total": float(n_degradation_escalations),
        "degradation_deescalations_total": float(
            n_degradation_deescalations),
    }


# ---------------------------------------------------------------- exporters

def _finite(v) -> bool:
    return isinstance(v, (int, float)) and math.isfinite(v)


def prometheus_text(requests: Iterable[Request],
                    slo: Union[SLOConfig, Dict[str, SLOConfig], None] = None,
                    counters: Optional[Dict[str, float]] = None,
                    labeled: Optional[Dict[str, Dict[str, float]]] = None,
                    prefix: str = "repro") -> str:
    """Render the serving metrics in Prometheus text exposition format
    (the /metrics payload of serving/server.py).

    Emits TTFT/TBT p50/p90/p99 + means as quantile-labeled gauges,
    per-SLO-class attainment/latency/preemption breakdowns
    (``slo_class`` label), prefix-cache hit rate, and preemption/swap
    counters — all derived from the SAME ``request_metrics`` /
    ``per_class_metrics`` the offline reports print, so live scrapes and
    trace-replay summaries can never disagree on definitions.

    ``counters`` adds flat ``{prefix}_<name> value`` lines (server-level:
    http request totals, queue depth, pool occupancy); ``labeled`` adds
    one family per entry with a ``{key="..."}`` label per sample, e.g.
    ``{"http_responses_total|status": {"200": 31, "429": 4}}`` — the part
    after ``|`` names the label key.  Time-valued metrics are in the
    serving clock's unit (wall seconds under the HTTP front-end).
    NaN samples (e.g. percentiles over zero completed requests) are
    DROPPED rather than exported — scrapers choke on them and a missing
    sample is the honest statement."""
    reqs = list(requests)
    m = request_metrics(reqs, None if isinstance(slo, dict) else slo)
    per = per_class_metrics(reqs, slo)
    lines: List[str] = []

    def gauge(name: str, value, labels: str = "",
              help_text: str = "") -> None:
        if not _finite(value):
            return
        full = f"{prefix}_{name}"
        if help_text and not any(ln.startswith(f"# TYPE {full} ")
                                 for ln in lines):
            lines.append(f"# HELP {full} {help_text}")
            lines.append(f"# TYPE {full} gauge")
        lines.append(f"{full}{labels} {value:.9g}")

    gauge("requests_completed", m["n_requests"],
          help_text="requests with at least one emitted token")
    for base, help_text in (
            ("ttft", "time to first token (serving clock units)"),
            ("tbt", "time between tokens (serving clock units)")):
        for q in ("50", "90", "99"):
            gauge(base, m[f"{base}_p{q}"],
                  labels=f'{{quantile="0.{q}"}}', help_text=help_text)
        gauge(f"{base}_mean", m[f"{base}_mean"])
    gauge("queue_delay_mean", m["queue_delay_mean"],
          help_text="arrival to first admission")
    gauge("queue_delay", m["queue_delay_p99"], labels='{quantile="0.99"}')
    gauge("preemptions_total", m["n_preemptions"],
          help_text="memory-pressure evictions executed")
    gauge("swaps_total", m["n_swaps"],
          help_text="swap-to-host evictions executed")
    gauge("prefix_hit_rate", m["prefix_hit_rate"],
          help_text="cached / admitted prompt tokens")
    gauge("handoffs_total", m["n_handoffs"],
          help_text="prefill->decode pool migrations completed")
    if m["n_handoffs"]:
        gauge("handoff_moved_tokens_total", m["handoff_moved_tokens"],
              help_text="KV tokens whose payload crossed the pool link")
        gauge("handoff_linked_tokens_total", m["handoff_linked_tokens"],
              help_text="KV tokens linked to pages already warm on the "
                        "decode pool")
        gauge("handoff_link_ratio", m["handoff_link_ratio"],
              help_text="linked / (linked + moved) handoff tokens")
    if _finite(m.get("spec_acceptance_rate")):
        gauge("spec_acceptance_rate", m["spec_acceptance_rate"],
              help_text="accepted / drafted speculative tokens")
    if "slo_attainment" in m:
        gauge("slo_attainment", m["slo_attainment"],
              help_text="fraction meeting TTFT and every TBT SLO")
    for cls, cm in per.items():
        lab = f'{{slo_class="{cls}"}}'
        gauge("class_requests_completed", cm["n_requests"], lab,
              help_text="completed requests per SLO class")
        for q in ("50", "99"):
            gauge("class_ttft", cm[f"ttft_p{q}"],
                  f'{{slo_class="{cls}",quantile="0.{q}"}}',
                  help_text="per-class time to first token")
            gauge("class_tbt", cm[f"tbt_p{q}"],
                  f'{{slo_class="{cls}",quantile="0.{q}"}}',
                  help_text="per-class time between tokens")
        gauge("class_preemption_rate", cm["preemption_rate"], lab)
        gauge("class_prefix_hit_rate", cm["prefix_hit_rate"], lab)
        if "slo_attainment" in cm:
            gauge("class_slo_attainment", cm["slo_attainment"], lab,
                  help_text="per-class SLO attainment")
    for name, value in (counters or {}).items():
        gauge(name, value)
    for family, samples in (labeled or {}).items():
        name, _, key = family.partition("|")
        for label_value, value in samples.items():
            gauge(name, value, f'{{{key or "label"}="{label_value}"}}')
    return "\n".join(lines) + "\n"
