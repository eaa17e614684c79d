"""Drafters for speculative verify-k decoding — the JAX package's
``serving/spec.py`` with the draft-model builder rewritten in torch.

Two drafters sit behind one tiny interface — ``propose(history, k)``
returns up to ``k`` proposed continuation tokens for one request:

  * ``NgramDrafter`` — draft-free prompt/self-lookup: match the last
    ``n`` tokens of the request's own history (prompt + everything
    generated) against an earlier occurrence and propose the tokens that
    followed it.  Pure host-side numpy, zero extra launches; proposals
    are naturally variable-length (no match -> no speculation for that
    request this iteration).
  * the draft-model path — a tiny ``DecoderModel`` (any config from
    ``configs/``, same vocab as the target) greedily extended ``k`` steps
    by the engine over the full (padded) history.  The draft is
    *stateless* — it keeps no KV cache — so preemption, folding and swap
    need no draft-side bookkeeping at all.  This module only builds the
    model.

Correctness never depends on the drafter: verification accepts exactly
the prefix that matches the target's own greedy argmax, so any proposal
stream yields bit-identical output tokens — drafters only change how many
tokens each launch commits.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class NgramDrafter:
    """Prompt-lookup / self-lookup n-gram proposer.

    Tries suffix lengths ``max_n .. 1``: for each, scans earlier
    occurrences of the history's suffix most-recent-first and proposes
    the (up to ``k``) tokens that followed one.  A match near the end of
    the history has its continuation truncated by the history boundary —
    on periodic histories (the n-gram sweet spot) the most recent match
    would propose a single token where an earlier occurrence of the same
    suffix offers the full window — so the scan returns the most recent
    match whose continuation fills ``k``, falling back to the most recent
    longest one.  Deterministic, O(len(history)^2) worst case on
    histories bounded by ``max_len`` — negligible next to a launch.
    """

    def __init__(self, max_n: int = 3):
        assert max_n >= 1
        self.max_n = max_n

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.asarray(history)
        n_hist = len(h)
        for n in range(min(self.max_n, n_hist - 1), 0, -1):
            suffix = h[n_hist - n:]
            best = np.empty(0, dtype=np.int64)
            for s in range(n_hist - n - 1, -1, -1):
                if np.array_equal(h[s:s + n], suffix):
                    cont = h[s + n:s + n + k]
                    if len(cont) == k:
                        return cont.astype(np.int64)
                    if len(cont) > len(best):
                        best = cont.astype(np.int64)
            if len(best):
                return best
        return np.empty(0, dtype=np.int64)


def build_draft_model(config_name: str, vocab_size: int, seed: int = 1,
                      device=None, dtype: Optional[str] = None
                      ) -> Tuple[object, dict]:
    """Construct a tiny draft model from a registered config's smoke
    variant, its weights drawn from an explicit ``torch.Generator`` seeded
    with ``seed`` on ``device`` (``cuda`` unless the caller asks for the
    CPU).  ``dtype`` overrides the smoke variant's fp32 (the kernels on
    the card take bf16).  The draft must share the target's vocabulary —
    token ids are what verification compares."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import DecoderModel

    cfg = get_smoke_config(config_name)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype)
    if cfg.vocab_size != vocab_size:
        raise ValueError(
            f"draft config {config_name!r} has vocab {cfg.vocab_size}, "
            f"target has {vocab_size}; drafts must share the tokenizer")
    model = DecoderModel(cfg, device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    return model, model.init_params(gen)


def accepted_prefix(proposed: np.ndarray, target: np.ndarray) -> int:
    """Length of the verified prefix: ``proposed[j]`` is accepted iff it
    equals the target argmax after position ``j`` (``target[j]``), and
    every earlier draft was accepted too."""
    a = 0
    for j in range(len(proposed)):
        if int(proposed[j]) != int(target[j]):
            break
        a += 1
    return a
