"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.  Every test here carries the ``cuda`` marker and
skips where there is no CUDA device (the kernels have no CPU mode).  This
file imports neither JAX nor the JAX package, so it also runs on a machine
with only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        -W ignore::pytest.PytestUnknownMarkWarning tests/test_torch_cuda.py

Tolerances: bf16 inputs against the fp32 plain versions — attention
within atol = rtol = 2e-2, the ragged SwiGLU within 1e-2 relative
Frobenius (the kernel rounds H to bf16 for the tensor cores)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def _ragged_layout(e, m_blk, counts):
    padded = [-(-c // m_blk) * m_blk for c in counts]
    n_rows = sum(padded) + m_blk            # leave a sentinel tail tile
    te = []
    for ex, p_ in enumerate(padded):
        te += [ex] * (p_ // m_blk)
    te += [e] * ((n_rows - sum(padded)) // m_blk)
    return n_rows, np.asarray(te, np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    return torch.device("cuda")


def _bf16(rng, shape, dev, scale=1.0):
    a = (rng.normal(size=shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(dev, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("e,d,f,m_blk,counts", [
    (4, 256, 128, 8, [16, 0, 3, 1]), (8, 128, 256, 64, [64, 0, 0, 70, 0, 0, 0, 1])])
def test_moe_gmm_ragged_kernel_matches_plain(cuda, e, d, f, m_blk, counts):
    n_rows, te = _ragged_layout(e, m_blk, counts)
    rng = np.random.default_rng(0)
    args = (_bf16(rng, (n_rows, d), cuda), _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, d, f), cuda, d ** -0.5),
            _bf16(rng, (e, f, d), cuda, f ** -0.5),
            torch.from_numpy(te).to(cuda), m_blk)
    before = ops.LAUNCHES["moe_gmm_ragged"]
    got = ops.moe_gmm_ragged(*args).float()
    assert ops.LAUNCHES["moe_gmm_ragged"] == before + 1
    want = ref.moe_gmm_ragged_ref(*args).float()
    assert ((got - want).norm() / want.norm()).item() <= 1e-2


@pytest.mark.cuda
def test_attention_kernels_match_plain(cuda):
    rng = np.random.default_rng(1)
    b, p, s_max, h, hkv, hd = 3, 40, 128, 16, 2, 64
    q = _bf16(rng, (b, p, h, hd), cuda)
    k, v = _bf16(rng, (b, s_max, hkv, hd), cuda), _bf16(rng, (b, s_max, hkv, hd), cuda)
    off = torch.tensor([0, 50, 88], dtype=torch.int32, device=cuda)
    for window in (None, 20):
        got = ops.prefill_attention(q, k, v, off, window=window).float()
        want = ref.prefill_attention_ref(q, k, v, off, window=window).float()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)
        lens = off + 7
        got = ops.decode_attention(q[:, 0].contiguous(), k, v, lens,
                                   window=window).float()
        want = ref.decode_attention_ref(q[:, 0], k, v, lens,
                                        window=window).float()
        torch.testing.assert_close(got, want, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_kernels_refuse_float32_on_the_card(cuda):
    q = torch.zeros(1, 2, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        ops.prefill_attention(q, k, k, torch.zeros(1, dtype=torch.int32,
                                                   device=cuda))


@pytest.mark.cuda
def test_engine_serves_on_the_card(cuda):
    """The reduced qwen3 model in bf16 through the port's launcher on the
    card: every request completes and every kernel launches."""
    from repro_torch.launch.serve import ServeArgs, serve_real
    ops.reset_launches()
    r = serve_real(ServeArgs(smoke=True, dtype="bfloat16", requests=3,
                             max_len=128, quantum=32, token_budget=32))
    assert r["completed"] == r["requests"] == 3
    assert all(n > 0 for n in ops.LAUNCHES.values()), ops.LAUNCHES


@pytest.mark.cuda
def test_engine_preempts_on_the_card(cuda):
    """A pool too small for the trace forces recompute preemption (and
    the boundary-stash regather) on the card; every request still gets
    all its tokens."""
    from repro_torch.core.base import make_scheduler
    from repro_torch.launch.serve import ServeArgs, build_model
    from repro_torch.serving.engine import Engine
    model, params = build_model(ServeArgs(smoke=True, dtype="bfloat16"))
    sched = make_scheduler("layered", model.n_blocks, n_slots=4, quantum=8)
    # 28 four-token pages: the schedule (not the token values) decides
    # the pressure, and it evicts once for this trace
    eng = Engine(model, params, sched, n_slots=4, max_len=64, pages=28,
                 page_size=4, decode_reserve=1)
    rng = np.random.default_rng(0)
    for _ in range(8):
        eng.submit(rng.integers(1, 500, int(rng.integers(4, 24))).tolist(), 8)
    eng.run()
    assert eng.n_preempted > 0
    assert all(len(t) == 8 for t in eng.outputs.values())
    assert eng.alloc.pages_in_use() == 0
