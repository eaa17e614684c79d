"""Faults planted under the timed path, one for each a served cell can
have (one chip: no exchange between chips to leave out).  Each takes the
built engine and wraps its decode step; ``harness.run(hook=...)`` plants
one, and a run so broken has to come out not correct."""

from __future__ import annotations

import torch


def state_unchanged(eng):
    """The decode step computes its tokens but leaves the cache as it
    found it: the position each slot writes is put back afterwards."""
    step = eng._decode_step_impl

    def run(tokens, offsets, valid):
        slots = torch.arange(offsets.shape[0], device=offsets.device)
        at = offsets.long().clamp(max=eng.max_len - 1)
        saved = [[{k: v[:, slots, at].clone() for k, v in c.items()}
                  for c in seg] for seg in eng.cache]
        out = step(tokens, offsets, valid)
        for seg, old in zip(eng.cache, saved):
            for c, o in zip(seg, old):
                for k in c:
                    c[k][:, slots, at] = o[k]
        return out
    eng._decode_step_impl = run


def half_batch(eng):
    """The decode step runs the first half of the slots only: the rest
    get no cache write and no token of their own (0)."""
    step = eng._decode_step_impl

    def run(tokens, offsets, valid):
        keep = valid.clone()
        keep[keep.shape[0] // 2:] = False
        tok, loads = step(tokens, offsets, keep)
        return torch.where(keep, tok, torch.zeros_like(tok)), loads
    eng._decode_step_impl = run


def token_altered(eng):
    """Each decode token is altered where the step produces it."""
    step = eng._decode_step_impl
    vocab = eng.cfg.vocab_size

    def run(tokens, offsets, valid):
        tok, loads = step(tokens, offsets, valid)
        return (tok + 1) % vocab, loads
    eng._decode_step_impl = run


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch,
                                  token_altered)}
