"""The plain references against the port's CPU path on small seeded
configurations of both architectures (GQA + MoE; MLA + shared experts +
a dense block 0), from the benchmark's own weights."""

import pytest
import torch

from bench import harness, tiny
from bench import weights as Wt
from bench.reference import common


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cfg", [tiny.TINY_QWEN3, tiny.TINY_DEEPSEEK],
                         ids=["qwen3_moe", "deepseek_v2"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_reference_matches_the_ports_forward(cfg, seed):
    from repro_torch.models.model import DecoderModel
    model = DecoderModel(harness.port_config(cfg), device="cpu")
    params = Wt.draw(model.param_shapes(), seed, "cpu")
    tokens = torch.randint(1, cfg["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(seed))
    logits, _, _ = model.forward(params, tokens, dropless=True)
    ref = harness.reference(cfg)
    at = torch.arange(40)
    got = ref.logits(harness.run_config(cfg), Wt.Weights(params), tokens[0],
                     at)
    torch.testing.assert_close(got, logits[0], rtol=1e-4, atol=1e-4)


def test_the_fp8_control_departs_from_the_reference():
    cfg = tiny.TINY_QWEN3
    from repro_torch.models.model import DecoderModel
    model = DecoderModel(harness.port_config(cfg), device="cpu")
    params = Wt.draw(model.param_shapes(), 1, "cpu")
    w = Wt.Weights(params)
    seq = torch.arange(1, 33)
    ref = harness.reference(cfg)
    rc = harness.run_config(cfg)
    a = ref.logits(rc, w, seq, torch.arange(32), "fp32")
    b = ref.logits(rc, w, seq, torch.arange(32), "fp8")
    assert (a - b).abs().max() > 1e-2
    with pytest.raises(ValueError):
        common.lin(seq[None].float(), torch.ones(32, 2), "int3")


def test_weights_view_walks_the_segments_in_order():
    cfg = tiny.TINY_DEEPSEEK
    from repro_torch.models.model import DecoderModel
    model = DecoderModel(harness.port_config(cfg), device="cpu")
    params = Wt.draw(model.param_shapes(), 0, "cpu")
    w = Wt.Weights(params)
    assert w.n_layers == cfg["num_hidden_layers"]
    for i in range(w.n_layers):
        torch.testing.assert_close(
            w.layer(i)["attn/w_dq"],
            model.block_params(params, i)["attn"]["w_dq"])
    assert "mlp/w_gate" in w.layer(0) and "moe/router" in w.layer(1)
    again = Wt.draw(model.param_shapes(), 0, "cpu")
    for (p, h, k), (_, h2, k2) in zip(Wt.leaves(params), Wt.leaves(again)):
        assert torch.equal(h[k], h2[k2]), p


def test_config_files_map_to_the_ports_registry():
    """Each configuration file, as the port runs it, is the port's own
    registry entry at the file's depth."""
    import dataclasses
    from repro_torch.configs import get_config
    for name in ("qwen3-30b-a3b", "deepseek-v2-236b"):
        c = harness.load("configs", name)
        got = harness.port_config(c)
        reg = dataclasses.replace(get_config(name),
                                  n_layers=c["num_hidden_layers"],
                                  source=got.source,
                                  max_seq_len=got.max_seq_len)
        assert got == reg, name


def test_the_port_refuses_what_it_cannot_run():
    for base, key, bad in ((tiny.TINY_DEEPSEEK, "scoring_func", "sigmoid"),
                           (tiny.TINY_DEEPSEEK, "moe_layer_freq", 2),
                           (tiny.TINY_QWEN3, "use_sliding_window", True),
                           (tiny.TINY_QWEN3, "mlp_only_layers", [1])):
        with pytest.raises(ValueError):
            harness.port_config(dict(base, **{key: bad}))


def test_the_port_names_its_departures_and_the_reference_runs_them():
    """The configuration files hold the published settings; the port
    names each it cannot run, and both sides run it as the port does.
    The reference refuses the published settings the port departs from,
    so it cannot be run on a configuration other than the port's."""
    c = harness.load("configs", "deepseek-v2-236b")
    assert c["rope_scaling"]["type"] == "yarn" and c["n_group"] == 8
    got = {k: ran for k, _, ran, _ in harness.port_departures(c)}
    assert got == {"rope_scaling": None, "topk_method": "greedy",
                   "n_group": 1, "topk_group": 1, "norm_topk_prob": True,
                   "routed_scaling_factor": 1}
    q = harness.load("configs", "qwen3-30b-a3b")
    assert [k for k, *_ in harness.port_departures(q)] == ["qk_norm"]
    assert harness.port_departures(harness.run_config(c)) == []
    at = torch.arange(2)
    for cfg in (c, q):
        with pytest.raises(ValueError):
            harness.reference(cfg).logits(cfg, None, at, at)
