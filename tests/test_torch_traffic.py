"""The port's traffic generators and ``ServeConfig`` against the JAX
package's: the same seeds give the same traces (arrival times, lengths,
classes and token ids, exactly), ``engine_trace`` builds the same
open-loop trace, and ``validate`` rejects what the JAX class rejects."""

from __future__ import annotations

import dataclasses

import pytest

from repro.launch.config import ServeConfig as JaxServeConfig
from repro.serving import traffic as jt
from repro_torch.launch.config import ServeConfig
from repro_torch.serving import traffic as tt

SEEDS = [0, 1, 7, 123]


def _rows(trace):
    """A trace as plain tuples (the two packages' TraceRequest classes
    differ, their fields do not)."""
    return [dataclasses.astuple(r) for r in trace]


def test_dataset_models_match():
    assert list(tt.DATASETS) == list(jt.DATASETS)
    for name in jt.DATASETS:
        assert dataclasses.asdict(tt.DATASETS[name]) == \
            dataclasses.asdict(jt.DATASETS[name])
    assert sorted(tt.ARRIVAL_PROCESSES) == sorted(jt.ARRIVAL_PROCESSES)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("process", ["poisson", "bursty"])
@pytest.mark.parametrize("dataset", ["sharegpt", "arxiv"])
def test_arrival_processes_match(process, dataset, seed):
    got = tt.ARRIVAL_PROCESSES[process](tt.DATASETS[dataset], 1.3, 40,
                                        seed=seed)
    want = jt.ARRIVAL_PROCESSES[process](jt.DATASETS[dataset], 1.3, 40,
                                         seed=seed)
    assert _rows(got) == _rows(want)


@pytest.mark.parametrize("seed", SEEDS)
def test_length_model_samples_match(seed):
    import numpy as np
    lm = dict(mean=300.0, std=200.0, lo=16, hi=1024)
    got = tt.LengthModel(**lm).sample(np.random.default_rng(seed), 200)
    want = jt.LengthModel(**lm).sample(np.random.default_rng(seed), 200)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_multi_class_trace_and_prompt_tokens_match(seed):
    def specs(mod):
        return [mod.ClassSpec("batch", mod.DATASETS["arxiv"], 0.4, 12,
                              process="bursty"),
                mod.ClassSpec("interactive", mod.DATASETS["sharegpt"], 0.9,
                              20)]
    got = tt.multi_class_trace(specs(tt), seed=seed)
    want = jt.multi_class_trace(specs(jt), seed=seed)
    assert _rows(got) == _rows(want)
    assert {r.slo_class for r in got} == {"batch", "interactive"}
    got_t = tt.attach_prompt_tokens(got, 1000, seed=seed)
    want_t = jt.attach_prompt_tokens(want, 1000, seed=seed)
    assert _rows(got_t) == _rows(want_t)
    assert all(len(r.prompt_tokens) == r.prompt_len for r in got_t)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_prefixes,zipf", [(2, 1.2), (4, 0.8)])
def test_shared_prefix_trace_matches(seed, n_prefixes, zipf):
    kw = dict(n_prefixes=n_prefixes, prefix_len=24, suffix_len=6,
              output_len=5, rate=0.7, zipf_alpha=zipf, vocab_size=301,
              seed=seed)
    got = tt.shared_prefix_trace(16, **kw)
    want = jt.shared_prefix_trace(16, **kw)
    assert _rows(got) == _rows(want)


def test_trace_request_to_spec_matches():
    tr = tt.TraceRequest(1.5, 3, 4, slo_class="batch",
                         prompt_tokens=(5, 6, 7))
    jtr = jt.TraceRequest(1.5, 3, 4, slo_class="batch",
                          prompt_tokens=(5, 6, 7))
    assert dataclasses.asdict(tr.to_spec()) == \
        dataclasses.asdict(jtr.to_spec())


# the fields both classes hold, set away from their defaults
SHARED = dict(requests=11, max_len=200, rate=0.8, seed=3)


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
@pytest.mark.parametrize("batch_fraction", [0.0, 0.3, 1.0])
def test_engine_trace_matches(arrival, batch_fraction):
    kw = dict(SHARED, arrival=arrival, batch_fraction=batch_fraction)
    got = ServeConfig(**kw).validate().engine_trace(512)
    want = JaxServeConfig(**kw).validate().engine_trace(512)
    assert _rows(got) == _rows(want)


def test_defaults_and_derived_kwargs_match():
    """The port's fields have the JAX defaults (prefix caching on,
    recompute preemption, packed prefill), and the derived kwargs agree,
    key for key."""
    port, jax_ = ServeConfig(), JaxServeConfig()
    for f in dataclasses.fields(ServeConfig):
        if hasattr(jax_, f.name):
            assert getattr(port, f.name) == getattr(jax_, f.name), f.name
    assert port.prefix_cache is True
    for kw in ({}, dict(preemption="swap", host_pages=40, pages=10),
               dict(preemption="auto", class_headroom=4),
               dict(preemption="off", prefix_cache=False,
                    prefix_lru_pages=8, swap_in_budget=32),
               dict(spec="ngram", spec_k=3),
               dict(spec="draft", draft_config="qwen3-30b-a3b")):
        p, j = ServeConfig(**kw), JaxServeConfig(**kw)
        assert p.preemption_opts() == j.preemption_opts()
        assert p.scheduler_kwargs() == j.scheduler_kwargs()
        pe, je = p.engine_kwargs(), j.engine_kwargs()
        assert pe == je


BAD = [dict(scheduler="fcfs"), dict(clock="sundial"), dict(arrival="gamma"),
       dict(preemption="dma"), dict(moe_dispatch="sparse"), dict(rate=0),
       dict(requests=0), dict(slots=-1), dict(max_len=0), dict(page_size=0),
       dict(quantum=0), dict(token_budget=0), dict(ttft_slo=0),
       dict(tbt_slo=-1.0), dict(pages=0), dict(host_pages=-2),
       dict(swap_in_budget=0), dict(prefix_lru_pages=0),
       dict(batch_fraction=1.5), dict(batch_fraction=-0.1),
       dict(class_headroom=-1), dict(decode_reserve=-1),
       dict(spec="eagle"), dict(spec_k=0), dict(spec="draft"),
       dict(handoff="carrier"), dict(decode_pages=0),
       dict(decode_watermark=-1), dict(retry_budget=-1)]


@pytest.mark.parametrize("kw", BAD, ids=[next(iter(k)) + "=" + str(
    next(iter(k.values()))) for k in BAD])
def test_validate_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        JaxServeConfig(**kw).validate()
    with pytest.raises(ValueError):
        ServeConfig(**kw).validate()


def test_validate_checks_the_ports_own_fields():
    for kw in (dict(dtype="float16"), dict(prompt_len=(10, 5)),
               dict(new_tokens=(0, 4)), dict(arch="whisper-base")):
        with pytest.raises(ValueError):
            ServeConfig(**kw).validate()
    ServeConfig(arch="gpt-oss-20b", dtype="float32", prompt_len=(4, 9),
                scheduler="static").validate()


DISAGG_ARGV = ["--disagg", "--handoff", "whole", "--decode-pages", "40",
               "--decode-watermark", "3", "--fault-plan", "seed:7",
               "--retry-budget", "5"]


def test_disagg_and_chaos_flags_parse_as_jax():
    """``--disagg``/``--handoff``/``--decode-pages``/``--decode-watermark``
    and ``--fault-plan``/``--retry-budget``: JAX's defaults, and the same
    values from the same command line."""
    import argparse
    got, want = {}, {}
    for cls, out in ((ServeConfig, got), (JaxServeConfig, want)):
        ap = argparse.ArgumentParser()
        cls.add_arguments(ap)
        for argv in ([], DISAGG_ARGV):
            sc = cls.from_args(ap.parse_args(argv))
            out[bool(argv)] = {k: getattr(sc, k) for k in (
                "disagg", "handoff", "decode_pages", "decode_watermark",
                "fault_plan", "retry_budget")}
    assert got == want
    assert got[True] == dict(disagg=True, handoff="whole", decode_pages=40,
                             decode_watermark=3, fault_plan="seed:7",
                             retry_budget=5)
