"""The work formulas against hand counts at small shapes, and the
whole-step FLOPs against the port's own parameter counts."""

import json
from pathlib import Path

import pytest
import torch

from bench import tracing, work
from bench.reference import deepseek_v2, qwen3_moe

CONFIGS = Path(__file__).resolve().parent / "configs"


def test_k1_hand_count():
    # 5 assignments over 2 experts, d 4, F 3
    flops, nbytes = work.k1(5, 2, 4, 3)
    assert flops == 5 * (2 * 4 * 3 * 2 + 2 * 3 * 4)
    assert nbytes == 2 * (2 * 3 * 4 * 3 + 5 * 4 + 5 * 4)


def test_attention_hand_count():
    # one row: 2 new queries after 3 cached keys see 4 and 5 keys
    flops, nbytes = work.attention([(3, 2)], h=2, hkv=1, dk=4, dv=3)
    assert flops == 2 * 2 * (4 + 3) * (4 + 5)
    assert nbytes == 2 * (2 * 2 * 4 + 5 * 1 * (4 + 3) + 2 * 2 * 3)
    # decode: n = 1 at offset o sees o + 1 keys; empty rows count nothing
    f1, _ = work.attention([(7, 1), (0, 0)], h=1, hkv=1, dk=2, dv=2)
    assert f1 == 2 * 4 * 8


def test_bound_takes_the_larger():
    assert work.bound_s(989e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 3.35e12) == pytest.approx(1.0)


@pytest.mark.parametrize("name,ref", [("qwen3-30b-a3b", qwen3_moe),
                                      ("deepseek-v2-236b", deepseek_v2)])
def test_layer_flops_match_the_ports_parameter_counts(name, ref):
    """A token's matrix FLOPs are twice the parameters it touches, less
    the embedding lookup, the norms and the LM head (counted apart); MLA's
    decompression of its own latent is its w_uk and w_uv."""
    from bench.harness import port_config
    c = json.loads((CONFIGS / f"{name}.json").read_text())
    cfg = port_config(c)
    a = ref.arch(c)
    embed = cfg.vocab_size * cfg.d_model
    norms = 2 * cfg.d_model * cfg.n_layers
    active = cfg.active_param_count() - 2 * embed - norms
    assert sum(a["layer_flops"]) == 2 * active
    assert a["head_flops"] == 2 * cfg.d_model * cfg.vocab_size


def test_recorded_work_of_a_prefill_and_a_decode():
    rec = tracing.Recorder()
    valid = torch.tensor([[True, True, False], [False, False, False]])
    rec.prefill.append((0, 2, True, valid, torch.tensor([3, 0])))
    rec.decode.append((torch.tensor([True, False]), torch.tensor([9, 4])))
    counts = torch.tensor([2, 0, 1])          # 3 assignments, 2 experts
    rec.calls[("k1", "prefill")].append((0, (counts, 4, 3)))
    rec.calls[("k2", "prefill")].append((0, ((2, 3, 2, 4), (2, 8, 1, 4),
                                             3)))
    rec.calls[("k3", "decode")].append((0, ((2, 2, 4), (2, 16, 1, 4), 3)))
    arch = {"layer_flops": [10, 20, 30], "attn": (2, 1, 4, 3),
            "head_flops": 100}
    w = tracing.work(rec, arch)
    assert w["k1.prefill.flops"] == work.k1(3, 2, 4, 3)[0]
    assert w["attn.prefill.flops"] == work.attention([(3, 2)], 2, 1, 4,
                                                     3)[0]
    assert w["attn.decode.flops"] == work.attention([(9, 1)], 2, 1, 4,
                                                    3)[0]
    att = work.attention([(3, 2)], 2, 1, 4, 3)[0]
    assert w["model.prefill.flops"] == (10 + 20) * 2 + 2 * att + 100
    att1 = work.attention([(9, 1)], 2, 1, 4, 3)[0]
    assert w["model.decode.flops"] == 60 + 3 * att1 + 100
    assert w["prefill.tokens"] == 2 and w["decode.tokens"] == 1
