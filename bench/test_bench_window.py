"""The window's arithmetic and the traffic generator, on synthetic
token streams (CPU, no model)."""

import numpy as np
import pytest

from bench import tiny
from bench import traffic as T
from bench import window as W


def stream(n_req=4, n_tok=20, dt=0.1, t0=0.0):
    return [(r, t0 + r * 0.01 + i * dt) for i in range(n_tok)
            for r in range(n_req)]


def test_steady_stream():
    ev = stream()
    m = W.end_to_end({0: 0.0, 1: 0.0}, ev, end=10.0)
    assert m["tbt_p95_ms"] == pytest.approx(100.0)
    assert m["output_tokens_per_s"] == pytest.approx(80 / 10.0)
    assert m["ttft_p50_ms"] == pytest.approx(5.0)      # 0 and 10 ms


def test_planted_stall_raises_tbt_tail():
    ev = stream()
    stalled = [(r, t + 1.5 * (t >= 1.0) + 1.5 * (t >= 1.5))
               for r, t in ev]
    base = W.end_to_end({}, ev, end=10.0)["tbt_p95_ms"]
    hit = W.end_to_end({}, stalled, end=10.0)["tbt_p95_ms"]
    assert base == pytest.approx(100.0)
    # two 1.6 s gaps in each of 4 streams, 8 of 76: past the 95th
    assert hit > 10 * base


def test_request_without_first_token_counts_its_wait():
    ev = [(0, 0.5), (1, 0.7)]
    arrivals = {0: 0.0, 1: 0.0, 2: 1.0}          # 2 never got a token
    tt = W.ttfts(arrivals, W.first_times(ev), end=9.0)
    assert sorted(tt) == pytest.approx([0.5, 0.7, 8.0])
    assert W.end_to_end(arrivals, ev, 9.0)["ttft_p50_ms"] \
        == pytest.approx(700.0)


def test_gaps_only_inside_window():
    ev = [(0, -0.5), (0, 0.5), (0, 1.0), (0, 3.0)]
    assert W.gaps(ev, end=2.0) == pytest.approx([0.5])


def test_queue_waits_and_lateness():
    arr = {0: 0.0, 1: 1.0, 2: 5.0}
    assert W.queue_waits(arr, {0: 0.25, 1: 2.0}, end=4.0) \
        == pytest.approx([0.25, 1.0])
    assert W.lateness(arr, [0.3, 1.2, 2.0]) == pytest.approx([0.3, 0.2])


def test_percentile_matches_numpy():
    xs = list(np.random.default_rng(0).random(37))
    for q in (5, 50, 95):
        assert W.percentile(xs, q) == pytest.approx(np.percentile(xs, q))


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 7_000_000_123])
def test_every_seed_serves_the_same_work(seed):
    ref = T.build(tiny.TINY_TRAFFIC, rate=4.0, seconds=3.0, slots=3,
                  max_len=64, vocab=97, seed=1)
    got = T.build(tiny.TINY_TRAFFIC, rate=4.0, seconds=3.0, slots=3,
                  max_len=64, vocab=97, seed=seed)

    def work(tr):
        return ([(len(r.prompt), r.max_new) for r in tr.warmup],
                [r.arrival for r in tr.window],
                sorted((len(r.prompt), r.max_new) for r in tr.window))
    assert work(ref) == work(got) and len(got.window) > 3
    assert [r.prompt for r in got.window] != [r.prompt for r in ref.window]
    for r in got.warmup + got.window:
        assert len(r.prompt) + r.max_new <= 64 and r.max_new >= 1
        assert all(1 <= t < 97 for t in r.prompt)
    assert all(0 < r.arrival < 3.0 for r in got.window)


def test_the_seed_draws_the_order_of_the_windows_requests():
    def order(seed):
        return [len(r.prompt) for r in T.build(
            tiny.TINY_TRAFFIC, rate=4.0, seconds=3.0, slots=3, max_len=64,
            vocab=97, seed=seed).window]
    assert len({tuple(order(s)) for s in range(6)}) > 1


PROMPTS_ORDER = dict(tiny.TINY_TRAFFIC, order="prompts")


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 7_000_000_123])
def test_prompts_order_keeps_each_arrivals_output(seed):
    kw = dict(rate=4.0, seconds=3.0, slots=3, max_len=64, vocab=97)
    ref = T.build(tiny.TINY_TRAFFIC, seed=1, **kw)
    got = T.build(PROMPTS_ORDER, seed=seed, **kw)
    assert [(len(r.prompt), r.max_new) for r in got.warmup] \
        == [(len(r.prompt), r.max_new) for r in ref.warmup]
    # each arrival time keeps the base seed's output; the prompts are the
    # same set, drawn into another order
    base = np.random.default_rng(tiny.TINY_TRAFFIC["base_seed"])
    n = len(T.arrival_gaps(4.0, 3.0, base))
    _, outs, _ = T.sizes(tiny.TINY_TRAFFIC, 3 + n, 64, base)
    assert [r.max_new for r in got.window] == list(outs[3:])
    assert [r.arrival for r in got.window] == [r.arrival for r in ref.window]
    assert sorted(len(r.prompt) for r in got.window) \
        == sorted(len(r.prompt) for r in ref.window)
    assert all(len(r.prompt) + r.max_new <= 64 for r in got.window)


def test_prompts_order_is_drawn_from_the_seed():
    def order(seed):
        return [len(r.prompt) for r in T.build(
            PROMPTS_ORDER, rate=4.0, seconds=3.0, slots=3, max_len=64,
            vocab=97, seed=seed).window]
    assert len({tuple(order(s)) for s in range(6)}) > 1
    assert order(3) == order(3)


def test_prompt_order_fits_max_len_or_refuses():
    rng = np.random.default_rng(0)
    prompts, outs = np.array([50, 10, 30]), np.array([10, 50, 30])
    order = T.prompt_order(prompts, outs, 60, rng)
    assert np.all(prompts[order] + outs <= 60)
    with pytest.raises(ValueError):
        T.prompt_order(prompts, outs, 55, rng, tries=50)


def test_same_seed_same_requests():
    a = T.build(tiny.TINY_TRAFFIC, rate=4.0, seconds=3.0, slots=3,
                max_len=64, vocab=97, seed=5)
    b = T.build(tiny.TINY_TRAFFIC, rate=4.0, seconds=3.0, slots=3,
                max_len=64, vocab=97, seed=5)
    assert a == b


def test_lognormal_fit():
    x = T.lognormal(np.random.default_rng(0), 2340.0, 2088.0, 200_000)
    assert x.mean() == pytest.approx(2340.0, rel=0.02)
    assert x.std() == pytest.approx(2088.0, rel=0.05)


@pytest.mark.parametrize("name,max_len,share", [("arxiv", 16384, 0.10241),
                                                ("sharegpt", 6144, 0.06218)])
def test_clipped_share_of_the_cells_traffic(name, max_len, share):
    from bench import harness
    assert T.clipped_share(harness.load("traffic", name), max_len) \
        == pytest.approx(share)
