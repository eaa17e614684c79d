"""Whether what the timed path served is right: a sample of the requests
the window served, drawn from the seed, is run through the plain fp32
reference once each (prompt and served tokens, teacher-forced), and each
served token is judged by how far its reference logit lies below the
reference's best at that position (its gap); valid for greedy tokens,
which every cell serves.  The number compared, ``NUMBER``, is the share
of judged tokens whose gap exceeds ``TAU`` = 0.2; each cell states its
limit.  The widest gap and the mean gap, logged beside it, do not
separate the bf16 program from the fp8 control by three times: under
random weights routing has many near-ties, and both flip them, the
control more often but by the same steps; a gap past 0.2 takes the
control's continuous error, which bf16's rarely reaches.

The sample: the finished request that served the most tokens (else the
one in flight that did), one request that arrived inside the window (so
that the window's own prefill is judged), then finished ones in the
seed's order, up to the cell's ``requests`` and ``tokens``.

The control (``control=True``): the reference computed with float8 e4m3
operands in every matrix product, attention's included (the precision
below the configuration's bfloat16), at the same positions of the same
sequences; its reading is the gap of the token it puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch


def sample(served: Dict[int, Tuple[Sequence[int], List[int]]],
           finished: Sequence[int], window_ids: Sequence[int], seed: int,
           n_requests: int, n_tokens: int) -> List[int]:
    rng = np.random.default_rng([int(seed) % (1 << 63), 0xC4EC])
    have = [r for r in sorted(served) if served[r][1]]
    if not have:
        return []

    def size(r):
        return len(served[r][1]), len(served[r][0])
    fin = [r for r in sorted(finished) if r in have]
    pick = [max(fin or have, key=size)]
    win = [r for r in window_ids if r in have and r not in pick]
    if win:
        pick.append(win[int(rng.integers(len(win)))])
    rest = [r for r in fin if r not in pick]
    rest = [rest[i] for i in rng.permutation(len(rest))]
    for r in rest:
        if len(pick) >= n_requests \
                or sum(len(served[p][1]) for p in pick) >= n_tokens:
            break
        pick.append(r)
    return pick


def gaps(ref, cfg: dict, weights, prompt: Sequence[int], out: List[int],
         device, control: bool = False) -> Dict[str, float]:
    """The gaps of the served tokens ``out`` after ``prompt`` (and, with
    ``control``, of the control's first choices), summed up
    (``_summary``)."""
    vocab = cfg["vocab_size"]
    if any(not 0 <= t < vocab for t in out):
        bad = {"tokens": len(out), "max": float("inf"),
               "sum": float("inf"), "above": len(out)}
        return {"program": bad, "control": None}
    seq = torch.tensor(list(prompt) + out[:-1], dtype=torch.long,
                       device=device)
    at = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(out),
                      device=device)
    with torch.no_grad():
        ref32 = ref.logits(cfg, weights, seq, at, "fp32")
        best = ref32.max(-1).values
        tok = torch.tensor(out, dtype=torch.long, device=device)
        r = {"program": _summary(best - ref32.gather(1, tok[:, None])[:, 0]),
             "control": None}
        if control:
            low = ref.logits(cfg, weights, seq, at, "fp8").argmax(-1)
            r["control"] = _summary(
                best - ref32.gather(1, low[:, None])[:, 0])
    return r


TAU = 0.2
NUMBER = f"share_above_{TAU}"


def _summary(g: torch.Tensor) -> Dict[str, float]:
    """One request's gaps: their count, widest, sum and how many are
    above ``TAU``."""
    return {"tokens": int(g.numel()), "max": float(g.max()),
            "sum": float(g.sum()), "above": int((g > TAU).sum())}


def readings(judged: List[Dict[str, float]]) -> Dict[str, float]:
    """The sample's readings: ``NUMBER``, the one compared, and beside it
    ``max_logit_gap`` (the widest gap) and ``mean_logit_gap`` (the mean
    over every judged token).  A sample with no token reads infinite."""
    n = sum(j["tokens"] for j in judged)
    if not n:
        return {NUMBER: float("inf"), "max_logit_gap": float("inf"),
                "mean_logit_gap": float("inf")}
    return {NUMBER: sum(j["above"] for j in judged) / n,
            "max_logit_gap": max(j["max"] for j in judged),
            "mean_logit_gap": sum(j["sum"] for j in judged) / n}
