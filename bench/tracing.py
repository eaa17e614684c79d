"""Spans and counts of a traced run, recorded from the benchmark's own
files: wrappers around the calls into each layer, installed for the
traced run only (the untraced run installs none).  Each wrapper opens a
``torch.profiler.record_function`` span, reads its arguments, changes
none, and keeps the device tensors it needs (counts, masks, offsets) to
read after the window, so it adds no sync inside it.

Spans: ``bench.next_plan`` (Scheduler.next_plan), ``bench.execute_plan``
(Engine.execute_plan), ``bench.prefill`` (Engine._prefill_impl),
``bench.decode`` (Engine._decode_step_impl), ``bench.k1`` / ``bench.k2``
/ ``bench.k3`` (``kernels.ops``' moe_gmm_ragged, prefill_attention,
decode_attention) and ``bench.window`` around the whole window. The real
assignments of each K1 call come from the ``counts`` that
``models.moe.ragged_dispatch`` returns just before it.

``Profiler`` traces the window with the device's activity and, on the
host, the runtime calls and the ``record_function`` spans alone
(``RecordScope.USER_SCOPE``): no host operator is recorded. Tracing each
launch on the device still slows a host-paced cell's host by about a
third. ``reduce`` reads its events: a device operation belongs to the
spans in which the host launched it (its runtime call's correlation id;
where that is missing, its own start), busy time is the union of device
operations inside ``bench.window``, and each idle gap is named by the
innermost span the host was in when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

PHASES = ("prefill", "decode")
KERNELS = ("k1", "k2", "k3")
HOST_SPANS = ("bench.next_plan", "bench.execute_plan", "bench.prefill",
              "bench.decode", "bench.k1", "bench.k2", "bench.k3")


class Recorder:
    """The wrappers of one traced window and what they kept."""

    def __init__(self):
        self.phase: Optional[str] = None
        self.prefill: List[tuple] = []   # (start, n, emit, valid, offset)
        self.decode: List[tuple] = []    # (valid rows, offsets)
        self.calls: Dict[str, List[tuple]] = defaultdict(list)
        self._counts = None
        self._undo: List[tuple] = []

    # -- install / remove ---------------------------------------------------

    def _patch(self, obj, name: str, wrapper) -> None:
        had = name in vars(obj)
        self._undo.append((obj, name, getattr(obj, name), had))
        setattr(obj, name, wrapper)

    def install(self, eng) -> None:
        from repro_torch.kernels import ops
        from repro_torch.models import moe
        sched = eng.scheduler
        self._patch(sched, "next_plan", self._span(
            "bench.next_plan", sched.next_plan))
        self._patch(eng, "execute_plan", self._span(
            "bench.execute_plan", eng.execute_plan))
        self._patch(eng, "_prefill_impl", self._prefill(eng._prefill_impl))
        self._patch(eng, "_decode_step_impl",
                    self._decode(eng._decode_step_impl))
        self._patch(moe, "ragged_dispatch", self._dispatch(
            moe.ragged_dispatch))
        self._patch(ops, "moe_gmm_ragged", self._kernel(
            "k1", ops.moe_gmm_ragged))
        self._patch(ops, "prefill_attention", self._kernel(
            "k2", ops.prefill_attention))
        self._patch(ops, "decode_attention", self._kernel(
            "k3", ops.decode_attention))

    def remove(self) -> None:
        for obj, name, orig, had in reversed(self._undo):
            if had:
                setattr(obj, name, orig)
            else:
                delattr(obj, name)
        self._undo = []

    # -- wrappers -----------------------------------------------------------

    @staticmethod
    def _span(name, fn):
        def run(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return run

    def _prefill(self, fn):
        def run(start, n, emit, hidden, valid, slots, offset, length):
            self.prefill.append((start, n, emit, valid, offset))
            self.phase = "prefill"
            try:
                with record_function("bench.prefill"):
                    return fn(start, n, emit, hidden, valid, slots, offset,
                              length)
            finally:
                self.phase = None
        return run

    def _decode(self, fn):
        def run(tokens, offsets, valid_rows):
            self.decode.append((valid_rows, offsets))
            self.phase = "decode"
            try:
                with record_function("bench.decode"):
                    return fn(tokens, offsets, valid_rows)
            finally:
                self.phase = None
        return run

    def _dispatch(self, fn):
        def run(*a, **k):
            out = fn(*a, **k)
            self._counts = out[5]
            return out
        return run

    def _kernel(self, kind: str, fn):
        def run(*a, **k):
            phase = self.phase
            if phase is not None:
                rec = len(self.prefill if phase == "prefill"
                          else self.decode) - 1
                if kind == "k1":
                    info = (self._counts, a[0].shape[1], a[1].shape[2])
                else:
                    info = (tuple(a[0].shape), tuple(a[1].shape),
                            a[2].shape[-1])
                self.calls[(kind, phase)].append((rec, info))
            with record_function(f"bench.{kind}"):
                return fn(*a, **k)
        return run


# ---------------------------------------------------------------------------
# The profiler and its events
# ---------------------------------------------------------------------------


class Profiler:
    """Kineto over a block (the window): the device's activity (``cuda``)
    and, on the host, the runtime calls and the ``record_function`` spans
    only.  After the block, ``events()`` are its events."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity
        self.acts = {ProfilerActivity.CPU} | (
            {ProfilerActivity.CUDA} if cuda else set())
        self._result = None

    def __enter__(self):
        from torch._C._profiler import RecordScope, _ExperimentalConfig
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                             False, False, _ExperimentalConfig())
        _prepare_profiler(cfg, self.acts)
        _enable_profiler(cfg, self.acts, {RecordScope.USER_SCOPE})
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self._result = _disable_profiler()
        return False

    def events(self):
        return self._result.events()


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


def _flag(e, name: str):
    """An event accessor this torch may not have (None without it)."""
    f = getattr(e, name, None)
    return f() if f is not None else None


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class _Spans:
    """One span name's intervals on the host: which holds a time."""

    def __init__(self, iv: List[Tuple[int, int]]):
        self.iv = sorted(iv)
        self.starts = [a for a, _ in self.iv]

    def holds(self, t: int) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.iv[i][1]


def reduce(evs, top: int = 10) -> dict:
    """Device time by (phase, kernel) span, busy and idle inside
    ``bench.window``, the device operations that took most time and the
    idle time by the span the host was in, from the events ``evs`` of a
    ``Profiler``."""
    from torch.autograd import DeviceType
    launch: Dict[int, int] = {}
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    dev = []
    for e in evs:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name.startswith("bench."):
                spans[name].append((_ns(e, "start"), _ns(e, "end")))
            elif name.startswith("cu"):          # a CUDA API call (cuda*, cu*)
                launch.setdefault(e.correlation_id(), _ns(e, "start"))
            continue
        if name.startswith("bench.") or _flag(e, "is_user_annotation"):
            continue
        a, b = _ns(e, "start"), _ns(e, "end")
        if b > a:
            dev.append((a, b, name, e.correlation_id(),
                        _flag(e, "linked_correlation_id")))
    if not spans.get("bench.window"):
        return {}
    w0, w1 = spans["bench.window"][0]
    dev = [d for d in dev if d[1] > w0 and d[0] < w1]
    host = {k: _Spans(v) for k, v in spans.items()}
    by_span: Dict[Tuple[str, str], float] = defaultdict(float)
    by_name: Dict[str, float] = defaultdict(float)
    unlinked = 0
    for a, b, name, cid, linked in dev:
        t = launch.get(cid, launch.get(linked))
        if t is None:
            unlinked += 1
            t = a
        s = (b - a) / 1e9
        by_name[name] += s
        ph = next((p for p in PHASES if f"bench.{p}" in host
                   and host[f"bench.{p}"].holds(t)), None)
        if ph is None:
            continue
        by_span[(ph, "all")] += s
        for k in KERNELS:
            if f"bench.{k}" in host and host[f"bench.{k}"].holds(t):
                by_span[(ph, k)] += s
    busy = _merge([(max(a, w0), min(b, w1)) for a, b, *_ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        where = "host: runtime loop"
        for k in reversed(HOST_SPANS):        # innermost first
            if k in host and host[k].holds(a):
                where = f"host: {k[len('bench.'):]}"
                break
        idle[where] += (b - a) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9, "busy_s": busy_s,
        "span_device_s": dict(by_span), "unlinked": unlinked,
        "n_device_ops": len(dev),
        "device_ops": [[n[:96], s] for n, s in sorted(
            by_name.items(), key=lambda x: -x[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            idle.items(), key=lambda x: -x[1])[:top]],
    }


# ---------------------------------------------------------------------------
# Work of the recorded calls (read after the window)
# ---------------------------------------------------------------------------


def _rows(valid, offset) -> List[Tuple[int, int]]:
    n = valid.reshape(valid.shape[0], -1).sum(dim=1).cpu().tolist()
    o = offset.cpu().tolist()
    return [(int(a), int(b)) for a, b in zip(o, n) if b > 0]


def work(rec: Recorder, arch: dict) -> dict:
    """Per phase: each kernel's summed bound seconds and the whole
    step's model FLOPs, from the recorded inputs."""
    from bench import work as W
    rows = {"prefill": [_rows(v, o) for _, _, _, v, o in rec.prefill],
            "decode": [_rows(v, o) for v, o in rec.decode]}
    out: Dict[str, float] = defaultdict(float)
    for (kind, phase), calls in rec.calls.items():
        if kind == "k1":
            counts = torch.stack([c for _, (c, _, _) in calls]).cpu()
            for (_, (_, d, f)), cnt in zip(calls, counts):
                fl, by = W.k1(int(cnt.sum()), int((cnt > 0).sum()), d, f)
                out[f"{kind}.{phase}.bound_s"] += W.bound_s(fl, by)
                out[f"{kind}.{phase}.flops"] += fl
        else:
            for r, (q, k, dv) in calls:
                h, dk, hkv = q[-2], q[-1], k[-2]
                fl, by = W.attention(rows[phase][r], h, hkv, dk, dv)
                out[f"attn.{phase}.bound_s"] += W.bound_s(fl, by)
                out[f"attn.{phase}.flops"] += fl
        out[f"{kind}.{phase}.calls"] += len(calls)
    lf, head = arch["layer_flops"], arch["head_flops"]
    for (start, n, emit, _, _), rs in zip(rec.prefill, rows["prefill"]):
        out["model.prefill.flops"] += _model_flops(
            lf[start:start + n], arch["attn"], rs, head if emit else 0)
    for rs in rows["decode"]:
        out["model.decode.flops"] += _model_flops(lf, arch["attn"], rs, head)
    out["prefill.tokens"] = sum(n for rs in rows["prefill"] for _, n in rs)
    out["decode.tokens"] = sum(len(rs) for rs in rows["decode"])
    return dict(out)


def _model_flops(layer_flops, attn, rows, head) -> float:
    from bench import work as W
    tokens = sum(n for _, n in rows)
    per_layer_attn = W.attention(rows, *attn)[0]
    return (sum(layer_flops) * tokens + len(layer_flops) * per_layer_attn
            + head * len(rows))
