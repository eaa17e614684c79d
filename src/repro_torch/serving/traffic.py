"""Workload generation: Poisson arrivals (the paper's traffic model) with
prompt/output length distributions fitted to the paper's Table 4 dataset
statistics (ShareGPT and arXiv-Summarization), a bursty (on/off modulated
Poisson) arrival process for the oversubscribed sweeps, and multi-class
trace composition for the multi-tenant SLO scenarios.

Lengths are lognormal fitted to (mean, std) and clipped — the fitted p90s
land close to the paper's measured p90 (checked in tests/test_traffic.py).
Every generator is seed-deterministic.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import SubmitSpec


@dataclass(frozen=True)
class LengthModel:
    mean: float
    std: float
    lo: int = 16
    hi: int = 131072

    def _mu_sigma(self) -> Tuple[float, float]:
        # lognormal with given mean m and std s:
        # sigma^2 = ln(1 + s^2/m^2); mu = ln m - sigma^2/2
        m, s = self.mean, self.std
        sigma2 = math.log(1.0 + (s * s) / (m * m))
        mu = math.log(m) - sigma2 / 2.0
        return mu, math.sqrt(sigma2)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        mu, sigma = self._mu_sigma()
        x = rng.lognormal(mu, sigma, size=n)
        return np.clip(x, self.lo, self.hi).astype(np.int64)


@dataclass(frozen=True)
class DatasetModel:
    name: str
    input_len: LengthModel
    output_len: LengthModel


# Paper Table 4.
SHAREGPT = DatasetModel(
    name="sharegpt",
    input_len=LengthModel(mean=2340, std=2088),
    output_len=LengthModel(mean=438, std=265),
)
ARXIV = DatasetModel(
    name="arxiv",
    input_len=LengthModel(mean=9194, std=5754),
    output_len=LengthModel(mean=231, std=104),
)

DATASETS = {"sharegpt": SHAREGPT, "arxiv": ARXIV}


@dataclass(frozen=True)
class TraceRequest:
    arrival_time: float
    prompt_len: int
    output_len: int
    # multi-tenant SLO class tag, carried through to the Request
    slo_class: str = "interactive"
    # actual token ids for real-engine replay (None in the simulator);
    # a tuple so the frozen dataclass stays hashable/comparable
    prompt_tokens: Optional[Tuple[int, ...]] = None

    def to_spec(self) -> SubmitSpec:
        """The one ingestion conversion: trace replay submits through the
        same ``SubmitSpec`` record as the HTTP front-end and benchmarks
        (core/plan.py) — executors never see a raw TraceRequest."""
        return SubmitSpec(max_new_tokens=self.output_len,
                          prompt_tokens=self.prompt_tokens,
                          prompt_len=self.prompt_len,
                          slo_class=self.slo_class,
                          arrival_time=self.arrival_time)


def poisson_trace(dataset: DatasetModel, rate: float, n_requests: int,
                  seed: int = 0,
                  slo_class: str = "interactive") -> List[TraceRequest]:
    """Exogenous Poisson arrivals at ``rate`` req/s (paper §5.1)."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_requests)
    arrivals = np.cumsum(gaps)
    ins = dataset.input_len.sample(rng, n_requests)
    outs = dataset.output_len.sample(rng, n_requests)
    return [TraceRequest(float(a), int(i), int(o), slo_class=slo_class)
            for a, i, o in zip(arrivals, ins, outs)]


def bursty_trace(dataset: DatasetModel, rate: float, n_requests: int,
                 seed: int = 0, *, mean_on: float = 4.0,
                 mean_off: float = 8.0,
                 slo_class: str = "interactive") -> List[TraceRequest]:
    """On/off modulated Poisson arrivals: exponential ON bursts (mean
    ``mean_on`` s) alternate with silent OFF gaps (mean ``mean_off`` s).
    During a burst, arrivals come at the PEAK rate
    ``rate * (mean_on + mean_off) / mean_on`` so the long-run average rate
    matches ``rate`` — the same x-axis as ``poisson_trace`` but with the
    head-of-line pressure spikes the multi-tenant and oversubscribed
    sweeps need.  Seed-deterministic."""
    assert mean_on > 0 and mean_off >= 0
    rng = np.random.default_rng(seed)
    peak = rate * (mean_on + mean_off) / mean_on
    arrivals: List[float] = []
    t = 0.0
    while len(arrivals) < n_requests:
        on_end = t + rng.exponential(mean_on)
        while len(arrivals) < n_requests:
            t += rng.exponential(1.0 / peak)
            if t > on_end:
                break
            arrivals.append(t)
        # the overshoot past on_end is discarded (memoryless), so the OFF
        # period starts exactly at the burst boundary
        t = on_end + (rng.exponential(mean_off) if mean_off else 0.0)
    ins = dataset.input_len.sample(rng, n_requests)
    outs = dataset.output_len.sample(rng, n_requests)
    return [TraceRequest(float(a), int(i), int(o), slo_class=slo_class)
            for a, i, o in zip(arrivals, ins, outs)]


ARRIVAL_PROCESSES = {"poisson": poisson_trace, "bursty": bursty_trace}


def shared_prefix_trace(n_requests: int, *, n_prefixes: int = 4,
                        prefix_len: int = 32, suffix_len: int = 8,
                        output_len: int = 8, rate: float = 1.0,
                        zipf_alpha: float = 1.2, vocab_size: int = 251,
                        seed: int = 0,
                        slo_class: str = "interactive") -> List[TraceRequest]:
    """Prompt-reuse workload for the prefix-cache evaluation: ``n_prefixes``
    fixed "system prompts" of ``prefix_len`` tokens, each request picking
    one Zipf(``zipf_alpha``)-distributed (popular prefixes dominate, like
    production template reuse) and appending ``suffix_len`` fresh random
    tokens.  Arrivals are Poisson at ``rate``; token ids land in
    [1, vocab_size).  With the defaults, ~80% of every prompt's tokens are
    shared with earlier requests of the same prefix.  Seed-deterministic;
    prompt_tokens are always attached (the whole point is token-content
    reuse)."""
    assert n_prefixes >= 1 and prefix_len >= 1 and suffix_len >= 0
    rng = np.random.default_rng(seed)
    prefixes = [tuple(int(x) for x in
                      rng.integers(1, vocab_size, prefix_len))
                for _ in range(n_prefixes)]
    # bounded Zipf over the prefix ids: p(k) ∝ (k+1)^-alpha
    w = np.arange(1, n_prefixes + 1, dtype=np.float64) ** -zipf_alpha
    w /= w.sum()
    arrivals = np.cumsum(rng.exponential(1.0 / rate, size=n_requests))
    out: List[TraceRequest] = []
    for a in arrivals:
        pfx = prefixes[int(rng.choice(n_prefixes, p=w))]
        sfx = tuple(int(x) for x in
                    rng.integers(1, vocab_size, suffix_len))
        toks = pfx + sfx
        out.append(TraceRequest(float(a), len(toks), output_len,
                                slo_class=slo_class, prompt_tokens=toks))
    return out


@dataclass(frozen=True)
class ClassSpec:
    """One tenant class of a mixed trace: its SLO class tag, length
    distribution, arrival rate/process and request count."""
    slo_class: str
    dataset: DatasetModel
    rate: float
    n_requests: int
    process: str = "poisson"       # "poisson" | "bursty"


def multi_class_trace(specs: Sequence[ClassSpec],
                      seed: int = 0) -> List[TraceRequest]:
    """Compose independent per-class arrival streams (each deterministic
    under ``seed`` with a distinct per-class substream) into one trace,
    merge-sorted by arrival time."""
    trace: List[TraceRequest] = []
    for i, spec in enumerate(specs):
        gen = ARRIVAL_PROCESSES[spec.process]
        trace.extend(gen(spec.dataset, spec.rate, spec.n_requests,
                         seed=seed * 1009 + i, slo_class=spec.slo_class))
    return sorted(trace, key=lambda tr: tr.arrival_time)


def attach_prompt_tokens(trace: Sequence[TraceRequest], vocab_size: int,
                         seed: int = 0) -> List[TraceRequest]:
    """Fill ``prompt_tokens`` with seed-deterministic ids in
    [1, vocab_size) so a simulator-shaped trace can replay on the real
    engine (which needs actual token values)."""
    rng = np.random.default_rng(seed)
    out = []
    for tr in trace:
        toks = tuple(int(x) for x in
                     rng.integers(1, vocab_size, tr.prompt_len))
        out.append(TraceRequest(tr.arrival_time, tr.prompt_len,
                                tr.output_len, slo_class=tr.slo_class,
                                prompt_tokens=toks))
    return out
