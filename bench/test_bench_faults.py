"""A whole run on the CPU (the harness past its look for a card) at a
small size: sound, it comes out correct; with the timed path broken
underneath, once for each fault a served cell can have, it comes out not
correct; and the fp8 control fails the limit.  (One chip: no exchange
between chips to leave out.)"""

import pytest
import torch

from bench import check as C
from bench import faults, harness, run as entry, tiny

SEED = 2**31 + 99


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(cfg, hook=None, control=False, trace=False):
    return harness.run("tiny", SEED, 1.2, trace, device="cpu",
                       cell=tiny.tiny_cell(), config=cfg,
                       traffic=tiny.TINY_TRAFFIC, hook=hook,
                       control=control)


CFGS = [tiny.TINY_QWEN3, tiny.TINY_DEEPSEEK]
IDS = ["qwen3_moe", "deepseek_v2"]


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_sound_run_is_correct_and_the_control_is_not(cfg):
    r = run(cfg, control=True)
    assert r["gap"] <= r["limit"]
    assert r["control"][C.NUMBER] > r["limit"]
    assert r["control_correct"] is False
    assert r["e2e"]["ttft_p50_ms"] > 0 and r["e2e"]["tbt_p95_ms"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    # float32 on the CPU: the served tokens are the reference's own
    assert r["readings"]["max_logit_gap"] == 0.0


@pytest.mark.parametrize("fault", list(faults.FAULTS.values()),
                         ids=list(faults.FAULTS))
@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_a_broken_timed_path_is_not_correct(cfg, fault):
    r = run(cfg, hook=fault)
    assert r["gap"] > r["limit"], r["readings"]


def test_a_traced_run_reads_its_spans_and_counts():
    """The traced path on the CPU: the profiler records the benchmark's
    spans (no device operation to read), the counters are read, and the
    readers of the host-side metrics find them."""
    r = run(tiny.TINY_QWEN3, trace=True)
    ctx = r["ctx"]
    assert ctx["trace"]["window_s"] > 0 and ctx["trace"]["busy_s"] == 0
    assert ctx["work"]["decode.tokens"] > 0
    assert ctx["work"]["model.decode.flops"] > 0
    for name in ("iter_ms", "queue_wait_ms", "expert_load_mb_per_iter",
                 "mfu.decode"):
        v = entry.reader(name)(ctx)
        assert v is not None and v > 0, name
    assert r["gap"] <= r["limit"]
