"""Traffic of a cell: open-loop arrivals and request sizes.

Lengths are lognormal, fitted to a dataset's (mean, std) as in the port's
``serving/traffic.py`` (copied here so the yardstick cannot move with the
program), clipped below at ``lo`` and so that prompt + output fits the
cell's ``max_len``.  The sizes and the arrival times come from the
traffic file's own ``base_seed``: every run seed serves the same set of
requests at the same times.  The run seed draws the order in which the
window's requests take those arrival times, and the token ids, in
[1, vocab), as the port's ``attach_prompt_tokens`` does (with the
weights drawn from it, the routing).  The traffic file's ``order`` says
what the seed orders: ``requests`` (the default), each request whole
with its prompt and output; or ``prompts``, where each arrival time
keeps the output the base seed gave it and the seed orders the prompts
alone over them (every pairing still fits ``max_len``), so that every
seed emits the same outputs at the same times.

The window's requests arrive by a Poisson process at the cell's rate
(the gaps of its arrivals inside ``seconds``).  Before the window, one
request per slot is submitted to fill the pool; each serves a remaining
output drawn between 1 and its full output length.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class Req:
    arrival: float          # seconds from the window's start (warm-up: 0)
    prompt: Tuple[int, ...]
    max_new: int


def lognormal(rng: np.random.Generator, mean: float, std: float,
              n: int) -> np.ndarray:
    """Lognormal draws with the given mean and standard deviation."""
    sigma2 = math.log(1.0 + (std * std) / (mean * mean))
    mu = math.log(mean) - sigma2 / 2.0
    return rng.lognormal(mu, math.sqrt(sigma2), size=n)


def sizes(spec: dict, n: int, max_len: int,
          rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray, int]:
    """``n`` (prompt, output) lengths of the traffic ``spec``: outputs
    clipped to [lo, max_len / 2], prompts to [lo, max_len - output].
    Returns the two arrays and how many prompts the cache length clipped."""
    p, o = spec["prompt"], spec["output"]
    outs = np.clip(lognormal(rng, o["mean"], o["std"], n), o["lo"],
                   max_len // 2).astype(np.int64)
    raw = lognormal(rng, p["mean"], p["std"], n)
    prompts = np.clip(raw, p["lo"], max_len - outs).astype(np.int64)
    return prompts, outs, int((raw > max_len - outs).sum())


def arrival_gaps(rate: float, seconds: float,
                 rng: np.random.Generator) -> np.ndarray:
    """The gaps of a Poisson process at ``rate`` whose arrivals fall
    inside ``seconds``."""
    times: List[float] = []
    t = rng.exponential(1.0 / rate)
    while t < seconds:
        times.append(t)
        t += rng.exponential(1.0 / rate)
    return np.diff(np.asarray([0.0] + times, np.float64))


@dataclass(frozen=True)
class Traffic:
    warmup: List[Req]        # one a slot, submitted before the window
    window: List[Req]        # arrivals inside the window
    clipped: int             # prompts cut to fit max_len, of warmup + window


def build(spec: dict, *, rate: float, seconds: float, slots: int,
          max_len: int, vocab: int, seed: int) -> Traffic:
    """The requests of one run: the same sizes and arrival times for
    every ``seed`` (from ``spec["base_seed"]``); the order of the
    window's sizes over its arrival times, and the token ids, drawn from
    ``seed``."""
    if spec.get("process", "poisson") != "poisson":
        raise ValueError(f"unknown arrival process {spec['process']!r}")
    base = np.random.default_rng(spec["base_seed"])
    gaps = arrival_gaps(rate, seconds, base)
    n = len(gaps)
    prompts, outs, clipped = sizes(spec, slots + n, max_len, base)
    left = np.maximum(1, np.ceil(base.uniform(0.0, 1.0, slots)
                                 * outs[:slots])).astype(np.int64)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    arrivals = np.cumsum(gaps)
    what = spec.get("order", "requests")
    if what == "requests":
        order = slots + rng.permutation(n)
        pairs = [(prompts[j], outs[j]) for j in order]
    elif what == "prompts":
        win = np.arange(slots, slots + n)
        order = win[prompt_order(prompts[win], outs[win], max_len, rng)]
        pairs = [(prompts[j], outs[i]) for i, j in zip(win, order)]
    else:
        raise ValueError(f"unknown order {what!r}")

    def tokens(k: int) -> Tuple[int, ...]:
        return tuple(int(x) for x in rng.integers(1, vocab, k))
    warmup = [Req(0.0, tokens(int(prompts[i])), int(left[i]))
              for i in range(slots)]
    window = [Req(float(t), tokens(int(p)), int(o))
              for t, (p, o) in zip(arrivals, pairs)]
    return Traffic(warmup, window, clipped)


def prompt_order(prompts: np.ndarray, outs: np.ndarray, max_len: int,
                 rng: np.random.Generator, tries: int = 1000) -> np.ndarray:
    """The first permutation drawn from ``rng`` that puts a prompt beside
    each output so that every pair fits ``max_len``."""
    for _ in range(tries):
        order = rng.permutation(len(prompts))
        if np.all(prompts[order] + outs <= max_len):
            return order
    raise ValueError(f"no order of the prompts fits max_len {max_len} "
                     f"in {tries} draws")


def clipped_share(spec: dict, max_len: int, n: int = 100_000) -> float:
    """The share of requests of the length model whose prompt the cache
    length clips (over ``n`` draws from the base seed)."""
    rng = np.random.default_rng(spec["base_seed"])
    return sizes(spec, n, max_len, rng)[2] / n
