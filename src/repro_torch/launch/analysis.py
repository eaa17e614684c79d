"""Roofline terms of a traced step (the JAX package's
``repro/launch/analysis.py``), for one NVIDIA H100 SXM a rank:

  compute term    = flops a rank / peak bf16 FLOP/s
  memory term     = bytes a rank / HBM bandwidth
  collective term = collective bytes a rank / NVLink bandwidth

Constants: the H100 SXM datasheet's 989e12 dense bf16 FLOP/s, 3.35e12 B/s
HBM3, and 450e9 B/s in each direction over NVLink 4 (900 GB/s both ways).
They are datasheet figures, not measurements.

The numbers come from tracing rank 0's step on fake tensors
(``launch/dryrun.py``), not from a compiler:

- flops: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops,
  with the formulas below for the kernels' custom ops (K1-K4 and the
  backward kernels of K2 and K4, as ``kernels/ops.py`` registers them)
  and for the xLSTM recurrences, which the dry-run traces as one op each
  (``one_op_recurrences``);
- bytes: each op's operands and results summed on rank 0, unfused (every
  elementwise op counts its own reads and writes; a fused program moves
  less); views move nothing, a gather the rows it reads, an in-place
  scatter what it writes (``op_bytes``);
- collective bytes: the result bytes of every collective the step calls
  (``sharding/collectives.RECORD``);
- peak memory a device: the highest sum of live storage bytes on rank 0
  over the step: parameters, cache, inputs and temporaries
  (``StepCost``).
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import ops  # noqa: F401  (registers K1-K4's ops)
from repro_torch.models import xlstm

Tensor = torch.Tensor

PEAK_FLOPS = 989e12         # bf16 dense / H100 SXM (datasheet)
HBM_BW = 3.35e12            # bytes/s / H100 SXM HBM3 (datasheet)
LINK_BW = 450e9             # bytes/s each direction, NVLink 4 (datasheet)


# ---------------------------------------------------------------- flops

@register_flop_formula(torch.ops.repro_torch.moe_gmm)
def _moe_gmm_flops(x_shape, wg_shape, wu_shape, wd_shape, *args,
                   out_shape=None, **kw) -> int:
    e, c, d = x_shape
    return 2 * e * c * d * wg_shape[-1] * 3


@register_flop_formula(torch.ops.repro_torch.moe_gmm_ragged)
def _moe_gmm_ragged_flops(rows_shape, wg_shape, wu_shape, wd_shape,
                          tile_shape, m_blk, *args, out_shape=None,
                          **kw) -> int:
    # every row of the worst-case buffer (the trace has no routing data)
    return 2 * rows_shape[0] * rows_shape[1] * wg_shape[-1] * 3


def _pairs(p: int, s_max: int, causal: bool, window: int = 0) -> int:
    """Query-key pairs of a prefill call from offset 0 (the dry-run's
    prefill); a causal call over a longer cache counts every key; a
    window bounds the keys of each query."""
    if causal and p == s_max:
        if window and window < p:
            return window * (window + 1) // 2 + (p - window) * window
        return p * (p + 1) // 2
    if causal and window:
        return p * min(s_max, window)
    return p * s_max


@register_flop_formula(torch.ops.repro_torch.prefill_attention)
def _prefill_flops(q_shape, k_shape, v_shape, off_shape, window, causal,
                   want_lse, *args, out_shape=None, **kw) -> int:
    b, p, h, dk = q_shape
    return 2 * b * h * _pairs(p, k_shape[1], causal, window) * (
        dk + v_shape[3])


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_flops(q_shape, k_shape, v_shape, len_shape, window, want_lse,
                  *args, out_shape=None, **kw) -> int:
    b, h, dk = q_shape
    keys = min(k_shape[1], window) if window else k_shape[1]
    return 2 * b * h * keys * (dk + v_shape[3])


@register_flop_formula(torch.ops.repro_torch.prefill_attention_bwd)
def _prefill_bwd_flops(q_shape, k_shape, v_shape, o_shape, lse_shape,
                       do_shape, off_shape, window, causal, *args,
                       out_shape=None, **kw) -> int:
    # five products a query-key pair: S = Q K^T again, dP = dO V^T,
    # dV += P^T dO, dQ += dS K, dK += dS^T Q
    b, p, h, dk = q_shape
    return 2 * b * h * _pairs(p, k_shape[1], causal, window) * (
        3 * dk + 2 * v_shape[3])


@register_flop_formula(torch.ops.repro_torch.moe_gmm_bwd)
def _moe_gmm_bwd_flops(x_shape, wg_shape, wu_shape, wd_shape, dy_shape,
                       *args, out_shape=None, **kw) -> int:
    # eight GEMMs of the forward's size: G and U again, dH = dY Wd^T,
    # dWd = H^T dY, dX from dG and dU, dWg, dWu
    e, c, d = x_shape
    return 2 * e * c * d * wg_shape[-1] * 8


# ------------------------------------------- the recurrences as one op each
# ``models/xlstm.py`` runs sLSTM's S steps and the chunkwise mLSTM's S/128
# chunks as Python loops.  On fake tensors every op of them costs a
# dispatch (xlstm-1.3b's ``train_4k`` traced in 318 s as loops, 17 s as one
# op each), so the dry-run swaps each loop for one op with a backward op
# (``one_op_recurrences``): shapes propagate, flops are the formulas below,
# bytes are the op's inputs and outputs (as one fused scan would move),
# and the backward's working memory is not seen.  Their real
# implementations refuse: real tensors never reach them.


def _all_valid(like: Tensor, valid: Optional[Tensor]) -> Tensor:
    return valid.bool() if valid is not None else torch.ones(
        like.shape[:2], dtype=torch.bool, device=like.device)


def _slstm_shapes(wx, r, c, n, h, m, valid):
    b, s, _ = wx.shape
    return [wx.new_empty((b, s, c.shape[-1]))] + [
        torch.empty_like(t) for t in (c, n, h, m)]


def _mlstm_shapes(q, k, v, log_i, log_f, C, n, m, valid):
    return [torch.empty_like(t) for t in (C, n, m, q)]


# each op's outputs from its inputs: sLSTM (hs, c, n, h, m) from (wx, r,
# c, n, h, m, valid); mLSTM (C, n, m, h) from (q, k, v, log_i, log_f, C,
# n, m, valid)
_ONE_OP = {"slstm_scan": _slstm_shapes, "mlstm_chunkwise": _mlstm_shapes}


def _define(name: str) -> None:
    shapes = _ONE_OP[name]

    @torch.library.custom_op(f"repro_torch::{name}", mutates_args=())
    def fwd(xs: List[Tensor]) -> List[Tensor]:
        raise RuntimeError(f"repro_torch::{name} is traced on fake "
                           "tensors only")

    @fwd.register_fake
    def _(xs):
        return shapes(*xs)

    @torch.library.custom_op(f"repro_torch::{name}_bwd", mutates_args=())
    def bwd(xs: List[Tensor], gs: List[Tensor]) -> List[Tensor]:
        raise RuntimeError(f"repro_torch::{name}_bwd is traced on fake "
                           "tensors only")

    @bwd.register_fake
    def _(xs, gs):
        return [torch.empty_like(x) for x in xs]


for _name in _ONE_OP:
    _define(_name)


class _OneOp(torch.autograd.Function):
    """A recurrence's op with its backward op, so that the dry-run's train
    step traces the backward too."""

    @staticmethod
    def forward(ctx, name, *xs):
        ctx.name = name
        ctx.save_for_backward(*xs)
        return tuple(getattr(torch.ops.repro_torch, name)(list(xs)))

    @staticmethod
    def backward(ctx, *gs):
        xs = ctx.saved_tensors
        outs = _ONE_OP[ctx.name](*xs)
        gs = [torch.zeros_like(o) if g is None else g
              for o, g in zip(outs, gs)]
        grads = getattr(torch.ops.repro_torch, ctx.name + "_bwd")(
            list(xs), gs)
        return (None,) + tuple(
            g if x.is_floating_point() else None for x, g in zip(xs, grads))


def _slstm_one_op(wx, r, state, valid):
    hs, *st = _OneOp.apply("slstm_scan", wx, r, *state,
                           _all_valid(wx, valid))
    return tuple(st), hs


def _mlstm_one_op(q, k, v, log_i, log_f, state, valid=None):
    *st, h = _OneOp.apply("mlstm_chunkwise", q, k, v, log_i, log_f, *state,
                          _all_valid(q, valid))
    return tuple(st), h


@contextlib.contextmanager
def one_op_recurrences():
    """Within it, ``models/xlstm.py``'s ``slstm_scan`` and
    ``mlstm_chunkwise`` are one op each (for fake tensors only)."""
    saved = xlstm.slstm_scan, xlstm.mlstm_chunkwise
    xlstm.slstm_scan, xlstm.mlstm_chunkwise = _slstm_one_op, _mlstm_one_op
    try:
        yield
    finally:
        xlstm.slstm_scan, xlstm.mlstm_chunkwise = saved


def _slstm_flops(xs_shapes) -> int:
    """sLSTM's recurrent product of every step: h (B, H, dh) by the four
    gates' (H, dh, dh) weights (no elementwise op is counted, as
    FlopCounterMode counts none)."""
    (b, s, _), (g, hh, dh, _) = xs_shapes[0], xs_shapes[1]
    return 2 * b * s * g * hh * dh * dh


def _mlstm_flops(xs_shapes) -> int:
    """The chunkwise mLSTM's products: within each chunk of W steps the
    scores and their values (2 W^2 dk a head each), and across chunks the
    carried state's read and update (2 W dk^2 each)."""
    b, s, hh, dk = xs_shapes[0]
    return 4 * b * s * hh * dk * (xlstm.CHUNK_W + dk)


@register_flop_formula(torch.ops.repro_torch.slstm_scan)
def _slstm_scan_flops(xs_shapes, *args, out_shape=None, **kw) -> int:
    return _slstm_flops(xs_shapes)


@register_flop_formula(torch.ops.repro_torch.slstm_scan_bwd)
def _slstm_scan_bwd_flops(xs_shapes, gs_shapes, *args, out_shape=None,
                          **kw) -> int:
    # the forward recomputed, then the two transposed products
    return 3 * _slstm_flops(xs_shapes)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise)
def _mlstm_chunkwise_flops(xs_shapes, *args, out_shape=None, **kw) -> int:
    return _mlstm_flops(xs_shapes)


@register_flop_formula(torch.ops.repro_torch.mlstm_chunkwise_bwd)
def _mlstm_chunkwise_bwd_flops(xs_shapes, gs_shapes, *args, out_shape=None,
                               **kw) -> int:
    return 3 * _mlstm_flops(xs_shapes)


# ---------------------------------------------------------------- bytes

def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


class StepCost(TorchDispatchMode):
    """Bytes moved (each op's operands and results, unfused) and the peak
    of live storage bytes, over the ops dispatched inside the mode.
    ``track`` registers tensors made before the mode (parameters, cache,
    inputs) as live."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, list] = {}

    def _key(self, t: torch.Tensor) -> int:
        return t.untyped_storage()._cdata

    def track(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        key = self._key(t)
        ent = self._refs.get(key)
        if ent is None:
            ent = self._refs[key] = [t.untyped_storage().nbytes(), 0]
            self.live += ent[0]
            self.peak = max(self.peak, self.live)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live -= ent[0]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.bytes += op_bytes(func, args, kwargs, out)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


# ops that read rows of their first operand by index: they move the rows
# they gather (the output), not the whole table
_GATHERS = {"aten.index.Tensor", "aten.index_select.default",
            "aten.gather.default", "aten.embedding.default"}


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one op moves, unfused: its tensor operands read and its
    results written.  Views and metadata ops move none; a gather moves the
    rows it reads (its index and its output, read and written); an in-place
    op (a scatter into a cache) its other operands, read and written."""
    outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    if not outs or getattr(func, "is_view", False):
        return 0
    ins = [t for t in tree_leaves((args, kwargs))
           if isinstance(t, torch.Tensor)]
    name = str(func)
    if name in _GATHERS:
        return sum(_nbytes(t) for t in ins[1:]) + 2 * sum(map(_nbytes, outs))
    if func._schema.is_mutable:
        return 2 * sum(_nbytes(t) for t in ins[1:])
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


# ---------------------------------------------------------------- report

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float                # flops a rank (traced, FlopCounterMode)
    hlo_bytes: float                # bytes a rank (traced, unfused)
    coll_bytes: float
    coll_by_kind: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0
    peak_memory_per_device: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        per_dev_model = self.model_flops / self.n_chips
        return per_dev_model / self.hlo_flops if self.hlo_flops else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "n_chips": self.n_chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.coll_bytes,
            "collective_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "peak_memory_per_device": self.peak_memory_per_device,
        }


def model_flops_estimate(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N_active·D for inference forward
    (N = active params, D = processed tokens)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        return 6.0 * n_active * d
    if shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        return 2.0 * n_active * d
    d = shape.global_batch * 1
    return 2.0 * n_active * d
