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
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import to_device, torch_dtype
from repro_torch.models.model import DecoderModel
from repro_torch.training.optimizer import AdamW, tree_leaves, tree_unflatten

Tensor = torch.Tensor


def loss_fn(model: DecoderModel, params, tokens: Tensor, targets: Tensor,
            mask: Tensor, enc_out: Optional[Tensor] = None):
    """Masked next-token cross entropy + router aux loss -> (total,
    metrics): ``loss``, ``ce``, ``aux_loss`` and ``dropped`` (dense-
    dispatch assignments over capacity, summed over blocks)."""
    logits, _, aux = model.forward(params, tokens, enc_out=enc_out,
                                   moe_dispatch="dense")
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    m = mask.float()
    ce = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    total = ce + aux["aux_loss"]
    return total, {"loss": total, "ce": ce, "aux_loss": aux["aux_loss"],
                   "dropped": aux["dropped"]}


def make_train_step(model: DecoderModel, opt: AdamW,
                    has_encoder: bool = False) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``batch`` holds ``tokens``, ``targets``, ``mask`` (and
    ``enc_out`` where ``has_encoder``) on the model's device.  The
    parameters and the optimizer's moments are updated in place (and
    returned)."""
    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            enc_out = batch.get("enc_out") if has_encoder else None
            loss, metrics = loss_fn(model, params, batch["tokens"],
                                    batch["targets"], batch["mask"], enc_out)
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
        params, opt_state, opt_metrics = opt.update(grads, opt_state, params)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


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
