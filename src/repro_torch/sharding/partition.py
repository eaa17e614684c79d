"""Sharding rules: per-parameter, per-cache-leaf and per-moment partition
specs, and the rank-local view of a sharded tensor.

The rules are the JAX package's (``repro/sharding/partition.py``), copied:
Megatron-style tensor parallelism for dense blocks (column-split
w_q/w_k/w_v/w_up/w_gate, row-split w_o/w_down), expert parallelism for MoE
stacks (experts over ``model``, the expert FFN width over ``data``),
vocab-parallel embedding and unembedding, a divisibility guard that
replicates a dim its axes do not divide, and right-aligned trailing specs
so scan-stacked leading axes stay unsharded.

A spec is a tuple with one entry per dim, each ``None``, one mesh axis
name or a tuple of several, exactly as JAX's ``PartitionSpec`` holds them
(``tuple(P(...))``, which keeps a one-axis tuple as its name); a
replicated leaf's spec is ``()``.  Trees are the
port's parameter and cache trees (nested dicts and lists), whose leaf
paths are JAX's (``segments/0/pattern/0/attn/w_q``, ``0/0/k``).  The spec
functions need of a mesh only ``shape`` (a mapping axis -> size) and
``axis_names``, so the JAX package's own mesh, or any stand-in with those
two attributes, gives the same specs.

There is no GSPMD in PyTorch: the port runs one program per rank over that
rank's local shards (``local_shard``) with explicit collectives
(``sharding/collectives.py``).  ``sharding_context`` installs the mesh the
model code reads through ``active_context``; ``shard_hint`` and
``shard_seq_hint`` keep the JAX names: outside a context they are no-ops,
inside one they cut a tensor that this rank holds whole over the hinted
axes down to the rank's own block (no communication).
"""

from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

_TLS = threading.local()

Spec = Tuple


def default_rules(mesh) -> dict:
    axes = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in axes)
    tp = ("model",) if "model" in axes else ()
    return {
        "batch": batch or None,
        "data": ("data",) if "data" in axes else None,
        "expert": tp or None,
        "expert_inner": ("data",) if "data" in axes else None,
        # capacity dim of the (E, C, d) dispatch buffer: co-sharded over
        # the batch axes
        "expert_cap": batch or None,
        "tp": tp or None,
        "vocab": tp or None,
        "seq": tp or None,      # sequence-sharded KV cache / seq parallelism
        None: None,
    }


@contextmanager
def sharding_context(mesh, rules: Optional[dict] = None):
    """Run the model code inside as rank ``mesh.rank`` of ``mesh`` (a
    ``collectives.Mesh``): the mixers, the MoE and the embedding then take
    their sharded paths."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (mesh, rules or default_rules(mesh))
    try:
        yield
    finally:
        _TLS.ctx = prev


def active_context():
    """``(mesh, rules)`` of the innermost ``sharding_context``, or None."""
    return getattr(_TLS, "ctx", None)


def _axes_size(mesh, roles) -> int:
    if roles is None:
        return 1
    if isinstance(roles, str):
        roles = (roles,)
    n = 1
    for r in roles:
        if r in mesh.shape:
            n *= mesh.shape[r]
    return n


def axes_index(mesh, axes) -> int:
    """This rank's block index over ``axes`` (major to minor, as a JAX
    spec entry lays blocks out); 0 for None."""
    if axes is None:
        return 0
    if isinstance(axes, str):
        axes = (axes,)
    i = 0
    for a in axes:
        if a in mesh.shape:
            i = i * mesh.shape[a] + mesh.coords[a]
    return i


def shard_hint(x, *roles):
    """Outside a context: ``x``.  Inside one: this rank's block of ``x``,
    which the rank holds whole, over the axes the roles name (a dim its
    axes do not divide stays whole, as the parameter guard keeps it)."""
    ctx = active_context()
    if ctx is None:
        return x
    mesh, rules = ctx
    spec = tuple(rules.get(r) for r in roles)
    spec = tuple(s if s is None or x.shape[i] % _axes_size(mesh, s) == 0
                 else None for i, s in enumerate(spec))
    return local_shard(x, spec, mesh)


def seq_layout(mesh, rules, b: int, s: int) -> Tuple[bool, bool]:
    """(batch split, sequence split) of the residual stream (B, S, D)
    between blocks: batch over the batch axes when they divide B; the
    sequence over the tensor-parallel axis when it divides S (Megatron
    sequence parallelism, the JAX package's ``shard_seq_hint``)."""
    tp_n = _axes_size(mesh, rules.get("tp"))
    return (b % max(_axes_size(mesh, rules.get("batch")), 1) == 0,
            tp_n > 1 and s % tp_n == 0)


def shard_seq_hint(x, b: Optional[int] = None):
    """Residual-stream layout between blocks.  Outside a context: ``x``.
    Inside one: from ``x`` (B_local, S, D), whole over the tensor-parallel
    axis, this rank's sequence block where that axis divides S (``b``, the
    global batch, says whether the rows are split; the rows are never cut
    here)."""
    ctx = active_context()
    if ctx is None or x.dim() != 3:
        return x
    mesh, rules = ctx
    _, s_split = seq_layout(mesh, rules, b if b is not None else x.shape[0],
                            x.shape[1])
    if not s_split:
        return x
    return local_shard(x, (None, rules.get("tp"), None), mesh)


# ---------------------------------------------------------------------------
# Parameter partition specs
# ---------------------------------------------------------------------------

# (path-regex, trailing-dims spec) — matched against the '/'-joined leaf
# path; first match wins; right-aligned so scan-stacked leading axes stay
# unsharded
_PARAM_RULES = [
    # MoE expert stacks (E, d, f) / (E, f, d): experts over the model axis,
    # the expert FFN width over the data axis ("expert-TP")
    (r"moe/w_(gate|up)$", ("expert", None, "expert_inner")),
    (r"moe/w_down$", ("expert", "expert_inner", None)),
    (r"moe/router$", (None, None)),
    (r"moe/shared/w_(gate|up)$", (None, "tp")),
    (r"moe/shared/w_down$", ("tp", None)),
    # Dense MLP: column/row parallel.
    (r"mlp/w_(gate|up)$", (None, "tp")),
    (r"mlp/w_down$", ("tp", None)),
    # Attention projections.
    (r"attn/w_(q|k|v)$", (None, "tp")),
    (r"attn/w_o$", ("tp", None)),
    (r"attn/x_(q|k|v)$", (None, "tp")),
    (r"attn/x_o$", ("tp", None)),
    # MLA: compressions replicated, decompressions TP.
    (r"attn/w_(dq|dkv|kr)$", (None, None)),
    (r"attn/w_(uq|uk|uv)$", (None, "tp")),
    # RG-LRU / xLSTM inner projections.
    (r"(rglru|lstm)/w_(in|gate|x|qkv|up)\w*$", (None, "tp")),
    (r"(rglru|lstm)/w_(out|down|o)\w*$", ("tp", None)),
    (r"(rglru|lstm)/(a_param|conv_w|conv_b|gates\w*)$", None),
    # Embedding / unembedding: vocab parallel.
    (r"embed/tok$", ("vocab", None)),
    (r"embed/lm_head$", (None, "vocab")),
]


def tree_map_with_path(fn, tree, path: Tuple = ()):
    """``fn(path, leaf)`` over a tree of dicts, lists and tuples; ``path``
    is the tuple of dict keys and list indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def map_with_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and its spec tree (as
    ``param_specs``/``cache_specs`` return it: specs are tuples, walked
    by the structure of ``tree``)."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_with_specs(fn, v, sp) for v, sp in zip(tree, specs)]
    return fn(tree, specs)


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


def spec_for_path(path_str_: str, ndim: int, rules: dict) -> Spec:
    for pat, trailing in _PARAM_RULES:
        if re.search(pat, path_str_):
            if trailing is None:
                return ()
            tdims = [rules.get(r) for r in trailing]
            n_trail = len(tdims)
            if ndim < n_trail:
                tdims = tdims[-ndim:]
                n_trail = ndim
            return tuple([None] * (ndim - n_trail) + tdims)
    return ()  # replicated by default (norms, biases, scalars)


def _entry(s):
    """A spec entry as ``PartitionSpec`` keeps it: one axis as its name."""
    if isinstance(s, tuple) and len(s) == 1:
        return s[0]
    return s


def _guard(spec: Sequence, shape, mesh) -> Spec:
    """Divisibility guard: a dim whose global size its axes do not divide
    is replicated instead (minicpm's 122753-row vocab on a 16-way axis)."""
    return tuple(_entry(s) if (s is None or i >= len(shape)
                               or shape[i] % _axes_size(mesh, s) == 0)
                 else None for i, s in enumerate(spec))


def param_specs(params, mesh, rules: Optional[dict] = None):
    """The parameter tree's specs, leaf by leaf."""
    rules = rules or default_rules(mesh)

    def leaf(path, x):
        shape = tuple(getattr(x, "shape", ()))
        return _guard(spec_for_path(path_str(path), len(shape), rules),
                      shape, mesh)
    return tree_map_with_path(leaf, params)


# ---------------------------------------------------------------------------
# Cache partition specs (serving)
# ---------------------------------------------------------------------------


def cache_specs(cache, mesh, batch: int, rules: Optional[dict] = None):
    """Specs for a segment-stacked cache tree.

    Leaf layouts (axis 0 is the segment-repeat stack, axis 1 the slot/batch):
      k/v/xk/xv  (R, B, S, kvH, hd) — batch over the batch axes; kv heads
                 over TP when it divides them, else the sequence over TP
                 when it divides it (GQA with few kv heads), else whole.
      ckv/kr     (R, B, S, r)       — MLA compressed cache: sequence.
      conv       (R, B, cw-1, W)    — recurrent conv tail: W over TP.
      h          (R, B, W)          — LRU state: W over TP.
      C/n/m/c    (R, B, ...)        — xLSTM states: batch only.
    """
    rules = rules or default_rules(mesh)
    bspec = rules.get("batch")
    if batch % max(_axes_size(mesh, bspec), 1) != 0:
        bspec = None           # e.g. long_500k batch=1: replicate
    tp = rules.get("tp")
    tp_n = _axes_size(mesh, tp)

    def leaf(path, x):
        name = str(path[-1])
        shape = tuple(x.shape)
        nd = len(shape)
        spec = [None] * nd
        if nd >= 2:
            spec[1] = bspec
        if name in ("k", "v", "xk", "xv") and nd == 5:
            if tp_n > 1 and shape[3] % tp_n == 0:
                spec[3] = tp            # shard kv heads (MHA-ish archs)
            elif tp_n > 1 and shape[2] % tp_n == 0:
                spec[2] = tp            # GQA few-kv-heads: shard sequence
        elif name in ("ckv", "kr") and nd == 4:
            if tp_n > 1 and shape[2] % tp_n == 0:
                spec[2] = tp
        elif name == "conv" and nd == 4:
            if tp_n > 1 and shape[3] % tp_n == 0:
                spec[3] = tp
        elif name == "h" and nd == 3:
            if tp_n > 1 and shape[2] % tp_n == 0:
                spec[2] = tp
        return tuple(_entry(e) for e in spec)

    return tree_map_with_path(leaf, cache)


def kv_cache_mode(mesh, rules, n_kv: int, cache_len: int) -> str:
    """How ``cache_specs`` lays a GQA cache's (S, kvH) axes over TP:
    "heads" (kv heads split), "seq" (sequence split) or "rep" (whole)."""
    tp_n = _axes_size(mesh, rules.get("tp"))
    if tp_n > 1 and n_kv % tp_n == 0:
        return "heads"
    if tp_n > 1 and cache_len % tp_n == 0:
        return "seq"
    return "rep"


# ---------------------------------------------------------------------------
# Optimizer-state partition specs (ZeRO-1)
# ---------------------------------------------------------------------------

# ``moment_specs`` is the JAX package's; ``zero1_plan`` says, leaf by leaf,
# how the sharded train step moves a gradient into its moment's layout
# (``training/train.py``) and how the optimizer updates the moment's slice
# of the parameter and gathers it back (``training/optimizer.py``).


def moment_specs(params, mesh, rules: Optional[dict] = None):
    """Adam moments: the parameter spec, then the largest still-replicated
    dim over the data axis where it divides (ZeRO-1)."""
    rules = rules or default_rules(mesh)
    return tree_map_with_path(
        lambda path, x: _moment_spec(path, x, mesh, rules), params)


def _moment_spec(path, x, mesh, rules) -> Spec:
    data_axes = rules.get("data")
    data_n = _axes_size(mesh, data_axes)
    shape = tuple(getattr(x, "shape", ()))
    nd = len(shape)
    base = _guard(spec_for_path(path_str(path), nd, rules), shape, mesh)
    if data_n <= 1 or nd == 0:
        return base
    spec = list(base) + [None] * (nd - len(base))
    if any(a in spec_axes(spec) for a in (data_axes or ())):
        return tuple(spec)
    cand = [i for i in range(nd)
            if spec[i] is None and shape[i] % data_n == 0]
    if cand:
        i = max(cand, key=lambda j: shape[j])
        spec[i] = _entry(data_axes)
    return tuple(spec)


def spec_axes(spec) -> set:
    """The mesh axes a spec names."""
    out = set()
    for e in spec:
        if e is not None:
            out.update((e,) if isinstance(e, str) else e)
    return out


@dataclass(frozen=True)
class Zero1Leaf:
    """How one parameter (spec ``spec``, moments ``moment``) has its
    gradient reach its ZeRO-1 moment shard on this rank: summed over
    ``reduce`` (the axes its spec leaves it whole on, but the one its
    moment cuts), and reduce-scattered over ``scatter`` along ``dim``
    where the moment spec cuts the leaf further than the parameter spec
    (``n`` blocks there, this rank's the ``j``-th; ``dim`` None where it
    does not); ``copies`` ranks hold each element of the moment shard
    (the global norm counts it once)."""
    spec: Spec
    moment: Spec
    reduce: Tuple[str, ...]
    scatter: Tuple[str, ...]
    dim: Optional[int]
    n: int
    j: int
    copies: int


def zero1_plan(shapes, mesh, rules: Optional[dict] = None):
    """A ``Zero1Leaf`` for every leaf of the parameter tree ``shapes``
    (global shapes, e.g. ``DecoderModel.param_shapes()``), seen from
    ``mesh``'s rank."""
    rules = rules or default_rules(mesh)
    data = tuple(a for a in (rules.get("data") or ()) if a in mesh.shape)

    def leaf(path, x):
        shape = tuple(x.shape)
        pspec = _guard(spec_for_path(path_str(path), len(shape), rules),
                       shape, mesh)
        mspec = _moment_spec(path, x, mesh, rules)
        whole = [a for a in mesh.axis_names
                 if a not in spec_axes(pspec) and mesh.shape[a] > 1]
        dim = next((i for i, e in enumerate(mspec)
                    if e != (pspec[i] if i < len(pspec) else None)), None)
        scatter = data if dim is not None else ()
        copies = 1
        for a in mesh.axis_names:
            if a not in spec_axes(mspec):
                copies *= mesh.shape[a]
        return Zero1Leaf(spec=pspec, moment=mspec,
                         reduce=tuple(a for a in whole if a not in scatter),
                         scatter=scatter, dim=dim,
                         n=_axes_size(mesh, scatter),
                         j=axes_index(mesh, scatter), copies=copies)
    return tree_map_with_path(leaf, shapes)


# ---------------------------------------------------------------------------
# Rank-local shards
# ---------------------------------------------------------------------------


def local_slices(shape, spec: Spec, mesh, coords=None) -> Tuple[slice, ...]:
    """The rank's block of a global ``shape`` under ``spec``: one slice per
    dim (``coords`` defaults to ``mesh.coords``)."""
    if coords is not None:
        mesh = _At(mesh, coords)
    out = []
    for i, n in enumerate(shape):
        s = spec[i] if i < len(spec) else None
        k = _axes_size(mesh, s)
        if k <= 1:
            out.append(slice(None))
            continue
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {s} ({k})")
        j = axes_index(mesh, s)
        out.append(slice(j * (n // k), (j + 1) * (n // k)))
    return tuple(out)


def param_blocks(params, mesh, coords=None,
                 rules: Optional[dict] = None) -> dict:
    """{'/'-joined leaf path: rank ``coords``' block (``local_slices``)}
    over the parameter tree ``params`` (global shapes) under
    ``param_specs``."""
    specs = param_specs(params, mesh, rules)
    out = {}

    def leaf(path, x):
        spec = specs
        for k in path:
            spec = spec[k]
        out[path_str(path)] = local_slices(tuple(x.shape), spec, mesh,
                                           coords)
    tree_map_with_path(leaf, params)
    return out


def local_shape(shape, spec: Spec, mesh) -> Tuple[int, ...]:
    return tuple(n // _axes_size(mesh, spec[i] if i < len(spec) else None)
                 for i, n in enumerate(shape))


def local_shard(x, spec: Spec, mesh, coords=None):
    """Rank ``coords``' (default: the mesh's own rank's) contiguous block
    of the global tensor ``x`` under ``spec``."""
    sl = local_slices(tuple(x.shape), spec, mesh, coords)
    if all(s == slice(None) for s in sl):
        return x
    return x[sl].contiguous()


class _At:
    """A mesh seen from other coordinates (for ``local_shard``)."""

    def __init__(self, mesh, coords):
        self.shape = mesh.shape
        self.axis_names = mesh.axis_names
        self.coords = dict(coords)
