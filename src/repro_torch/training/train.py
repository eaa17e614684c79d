"""Training loop: masked cross-entropy (+ MoE load-balance aux loss), the
train-step factory and a small Trainer driver with checkpointing — the
JAX package's ``training/train.py`` on torch autograd.

``loss_fn`` runs ``DecoderModel.forward`` as JAX's training path does:
no cache and the capacity-limited dense MoE dispatch (``moe_dispatch=
"dense"``, JAX's default; the port's serving default is ragged).  On the
card attention runs K2 and the experts K4, each differentiated by its
hand-written backward kernel (``kernels/ops.py``: ``PrefillAttention``,
``MoeGmm``); on the CPU their plain versions.  The optimizer updates the
parameters in place (``optimizer.py``).  A step reads nothing back to the
host: the metrics stay 0-dim tensors on the device, and ``Trainer.fit``
reads them in one transfer on each logged step only.

Under a ``sharding_context`` the step is one rank's program of the JAX
package's sharded step: its term of the loss (``_sharded_loss``), the
collectives' transposes in the backward, the gradients summed where JAX's
GSPMD sums them (``reduce_grads``) and ZeRO-1 AdamW.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import to_device, torch_dtype
from repro_torch.models.model import DecoderModel
from repro_torch.sharding import collectives as col
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (active_context, shard_hint,
                                            zero1_plan)
from repro_torch.training.optimizer import AdamW, tree_leaves, tree_unflatten

Tensor = torch.Tensor


def loss_fn(model: DecoderModel, params, tokens: Tensor, targets: Tensor,
            mask: Tensor, enc_out: Optional[Tensor] = None,
            global_batch: Optional[int] = None):
    """Masked next-token cross entropy + router aux loss -> (total,
    metrics): ``loss``, ``ce``, ``aux_loss`` and ``dropped`` (dense-
    dispatch assignments over capacity, summed over blocks).  Under a
    sharding context: ``_sharded_loss``, this rank's term."""
    if active_context() is not None:
        return _sharded_loss(model, params, tokens, targets, mask,
                             global_batch, enc_out)
    logits, _, aux = model.forward(params, tokens, enc_out=enc_out,
                                   moe_dispatch="dense")
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    m = mask.float()
    ce = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    total = ce + aux["aux_loss"]
    return total, {"loss": total, "ce": ce, "aux_loss": aux["aux_loss"],
                   "dropped": aux["dropped"]}


def _sharded_loss(model: DecoderModel, params, tokens: Tensor,
                  targets: Tensor, mask: Tensor, global_batch: int,
                  enc_out: Optional[Tensor] = None):
    """This rank's term of the sharded loss (the convention of
    ``sharding/collectives.py``: the step minimises the sum of the ranks'
    terms) from its rows of the batch: its masked cross-entropy sum over
    the global mask count, divided by the number of ranks that compute
    the same tokens, plus the aux loss (every rank holds the whole call's)
    over the world size.  Vocab-split logits are read where they lie
    (``layers.token_nll``: the rank's rows at every position, the same on
    every rank of ``model``); a head the guard keeps whole takes the
    plain loss at the rank's own positions; a softcap (recurrentgemma's)
    is elementwise, so it applies to the rank's columns as they lie.
    ``enc_out`` (whisper) is the rank's rows, whole over ``model``.  The
    metrics are the global ones, equal on every rank."""
    from repro_torch.models import layers
    mesh, rules = active_context()
    cfg = model.cfg
    s = tokens.shape[1]
    x, _, aux = model.forward(params, tokens, enc_out=enc_out,
                              moe_dispatch="dense",
                              global_batch=global_batch, return_hidden=True)
    lay = spmd.layout(mesh, rules, global_batch, s)
    tp, batch_axes = rules.get("tp"), rules.get("batch")
    emb = params["embed"]
    v_loc = (emb["tok"].shape[0] if cfg.tie_embeddings
             else emb["lm_head"].shape[1])
    if v_loc != cfg.vocab_size:
        x = spmd.gather_seq(mesh, rules, x, lay)
        nll = layers.token_nll(model.logits(params, x), targets, mesh, tp)
        m = mask.float()
        same = mesh.size(tp)
    else:
        nll = layers.token_nll(model.logits(params, x),
                               spmd.take_seq(mesh, rules, targets, lay),
                               mesh, None)
        m = spmd.take_seq(mesh, rules, mask, lay).float()
        same = 1 if lay.s_split else mesh.size(tp)
    count = mask.float().sum()
    if lay.b_split:
        count = col.all_reduce(mesh, count, batch_axes)
    else:
        same *= mesh.size(batch_axes)
    ce_part = torch.sum(nll * m) / torch.clamp(count, min=1.0) / same
    term = ce_part + aux["aux_loss"] / mesh.size_total
    ce = col.all_reduce(mesh, ce_part.detach(), mesh.axis_names)
    aux_loss = aux["aux_loss"].detach()
    return term, {"loss": ce + aux_loss, "ce": ce, "aux_loss": aux_loss,
                  "dropped": aux["dropped"]}


def reduce_grads(mesh, grads: list, plan: list) -> list:
    """Each leaf's gradient share (``grads``, in ``tree_leaves`` order)
    summed over the mesh axes its spec leaves it whole on, landing in its
    moment's layout (``plan``, ``partition.zero1_plan``'s leaves): a
    reduce-scatter over ``data`` where the moment cuts the leaf there, an
    all-reduce over the other axes; in fp32 (the moments' type).  Each
    share is dropped from ``grads`` once reduced."""
    out = []
    for i, lp in enumerate(plan):
        g, grads[i] = grads[i].float(), None
        if lp.dim is not None:
            g = col.reduce_scatter(mesh, g, lp.scatter, dim=lp.dim)
        out.append(col.all_reduce(mesh, g, lp.reduce))
    return out


def make_train_step(model: DecoderModel, opt: AdamW,
                    has_encoder: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens``, ``targets``, ``mask`` (and
    ``enc_out`` where ``has_encoder``) on the model's device.  The
    parameters and the optimizer's moments are updated in place (and
    returned).

    Under a sharding context (the JAX package's step under its mesh) the
    step runs as one rank: ``params`` are its shards
    (``convert.shard_params``), ``opt_state`` its ZeRO-1 moments
    (``opt.init(params, train_plan(model))`` or
    ``convert.shard_moments``), and ``batch`` the global batch, of which
    it takes its rows as JAX's ``shard_hint`` does.  The gradients are
    summed into the moments' layout (``reduce_grads``) and the optimizer
    runs ZeRO-1 (``AdamW.update_zero1``).  The step keeps its optimizer
    as ``train_step.opt``."""
    def train_step(params, opt_state, batch):
        ctx = active_context()
        gb = batch["tokens"].shape[0]
        tokens = shard_hint(batch["tokens"], "batch", None)
        targets = shard_hint(batch["targets"], "batch", None)
        mask = shard_hint(batch["mask"], "batch", None)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            enc_out = batch.get("enc_out") if has_encoder else None
            if enc_out is not None:
                enc_out = shard_hint(enc_out, "batch", None, None)
            loss, metrics = loss_fn(model, params, tokens, targets, mask,
                                    enc_out, global_batch=gb)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        del loss
        # a leaf the loss does not reach (whisper's encoder, fed enc_out
        # directly) gets a zero gradient, as under jax.grad
        grads = tree_unflatten(params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        plan = None
        if ctx is not None:
            plan = train_plan(model)
            shares = tree_leaves(grads)
            del grads
            grads = tree_unflatten(params, reduce_grads(
                ctx[0], shares, tree_leaves(plan)))
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params,
                                                    plan)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    train_step.opt = opt
    return train_step


def train_plan(model: DecoderModel):
    """The ZeRO-1 plan (``partition.zero1_plan``) of ``model``'s
    parameters on the active sharding context's rank."""
    mesh, rules = active_context()
    key = (tuple(mesh.shape.items()), mesh.rank, model.cfg)
    if key not in _PLANS:
        _PLANS[key] = zero1_plan(model.param_shapes(), mesh, rules)
    return _PLANS[key]


_PLANS: dict = {}


def device_batch(model: DecoderModel, tokens: np.ndarray, targets: np.ndarray,
                 mask: np.ndarray) -> dict:
    """One host batch on the model's device (copied without a host sync),
    with whisper's ``enc_out``: zeros of (B, n_frames, d_model), as the JAX
    package's Trainer and launcher give it."""
    dev = model.device
    batch = {"tokens": to_device(tokens, dev),
             "targets": to_device(targets, dev),
             "mask": to_device(mask, dev)}
    cfg = model.cfg
    if cfg.encoder.enabled:
        batch["enc_out"] = torch.zeros(
            (tokens.shape[0], cfg.encoder.n_frames, cfg.d_model),
            dtype=torch_dtype(cfg.dtype), device=dev)
    return batch


def read_metrics(m: dict) -> dict:
    """Every metric as a Python float, in ONE device-to-host transfer."""
    keys = list(m)
    vals = torch.stack([torch.as_tensor(m[k]).double().reshape(())
                        for k in keys]).tolist()
    return dict(zip(keys, vals))


@dataclass
class Trainer:
    model: DecoderModel
    opt: AdamW
    params: object
    opt_state: object = None
    step: int = 0
    history: list = field(default_factory=list)

    def __post_init__(self):
        if self.opt_state is None:
            self.opt_state = self.opt.init(self.params)
        self._step_fn = make_train_step(self.model, self.opt,
                                        self.model.cfg.encoder.enabled)

    def fit(self, batches: Iterator, steps: int,
            log_every: int = 10, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 100) -> list:
        from repro_torch.training import checkpoint as ckpt
        it = iter(batches)
        t0 = time.time()
        for _ in range(steps):
            tokens, targets, mask = next(it)
            batch = device_batch(self.model, tokens, targets, mask)
            self.params, self.opt_state, m = self._step_fn(
                self.params, self.opt_state, batch)
            self.step += 1
            if self.step % log_every == 0 or self.step == 1:
                rec = read_metrics(m)
                rec["step"] = self.step
                rec["wall"] = time.time() - t0
                self.history.append(rec)
            if checkpoint_path and self.step % checkpoint_every == 0:
                ckpt.save(checkpoint_path,
                          {"params": self.params, "opt": self.opt_state})
        return self.history
