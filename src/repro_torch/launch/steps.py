"""Step functions of the dry-run and the sharded runs (the JAX package's
``repro/launch/steps.py``):

  train   : (params, opt_state, batch) -> (params, opt_state, metrics)
  prefill : (params, cache, batch) -> (last_logits, cache, aux)
            (whisper's ``batch["enc_out"]`` holds the frames: encoded
            first, as JAX's step does; the cross K/V are not written to
            the cache, which ``precompute_cross_kv`` fills)
  decode  : (params, cache, batch) -> (logits, cache, aux)
  layered : (params, cache, batch) -> (logits, h_out, cache, aux)

Mesh-agnostic: outside a ``sharding_context`` they run the whole model;
inside one, as one rank over its shards (params, cache and batch rows),
with the logits gathered over the vocab.  The train step is
``training.train.make_train_step`` with JAX's AdamW (cosine, lr 3e-4,
1000 steps, 100 of warmup): under a context it takes the global batch,
runs its rank's rows and ZeRO-1 moments, and never gathers the logits.
Unlike JAX's steps the serve steps also
return the forward's ``aux`` (expert counts, drops), and they take the
last position's logits from its hidden state alone (the same values).
The port's ``DecoderModel.forward`` defaults to the ragged dispatch; the
steps pass JAX's default, ``"dense"`` with GShard capacity, unless told
otherwise (``dropless=True``: the serving engine's worst-case capacity,
under which the dense regimes' group-wise capacities cannot bind).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.shapes import InputShape, cache_len_for
from repro_torch.kernels import ops
from repro_torch.models.model import DecoderModel
from repro_torch.sharding import collectives as col
from repro_torch.sharding.partition import active_context

Tensor = torch.Tensor


def gather_vocab(cfg, logits: Tensor) -> Tensor:
    """Logits whole over the vocab: the rank's vocab columns gathered over
    ``model`` where the unembedding is split."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    mesh, rules = active_context()
    return col.all_gather(mesh, logits, rules.get("tp"), dim=-1)


def make_step_fn(model: DecoderModel, shape: InputShape,
                 moe_dispatch: str = "dense",
                 dropless: bool = False) -> Callable:
    cfg = model.cfg
    if shape.kind == "train":
        from repro_torch.training.optimizer import adamw
        from repro_torch.training.train import make_train_step
        return make_train_step(model, adamw(lr=3e-4, schedule="cosine",
                                            total_steps=1000, warmup=100),
                               cfg.encoder.enabled)
    cache_len = cache_len_for(cfg, shape)
    gb = shape.global_batch

    if shape.kind == "prefill":
        def prefill_step(params, cache, batch):
            tokens = batch["tokens"]
            offset = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                                 device=tokens.device)
            # whisper: the frames through the encoder, as JAX's step does
            frames = batch.get("enc_out")
            enc_out = (model.encode(params, frames, global_batch=gb)
                       if frames is not None else None)
            logits, cache, aux = model.forward(
                params, tokens, cache=cache, offset=offset, enc_out=enc_out,
                extra_embeds=batch.get("extra_embeds"),
                moe_dispatch=moe_dispatch, dropless=dropless, last_only=True,
                global_batch=gb, cache_len=cache_len)
            return gather_vocab(cfg, logits[:, -1]), cache, aux
        return prefill_step

    def decode_step(params, cache, batch):
        logits, cache, aux = model.forward(
            params, batch["tokens"], cache=cache, offset=batch["offsets"],
            moe_dispatch=moe_dispatch, dropless=dropless, last_only=True,
            global_batch=gb, cache_len=cache_len)
        return gather_vocab(cfg, logits[:, -1]), cache, aux
    return decode_step


def slice_row(cache, slot: int, global_batch: int):
    """Slot ``slot``'s cache row, (reps, 1, ...) per leaf.  Unsharded (or
    with the batch whole on every rank): views, which ``run_blocks``
    writes in place.  Batch-split: the owner's row, whole on every rank
    (summed over the batch axes from the owner's copy and zeros)."""
    ctx = active_context()
    owner = _owner(ctx, slot, global_batch)
    if owner is None:
        return ops.tree_map(lambda a: a[:, slot:slot + 1], cache)
    mesh, rules, mine, local = owner
    rows = ops.tree_map(
        lambda a: (a[:, local:local + 1] if mine
                   else torch.zeros_like(a[:, :1])), cache)
    return ops.tree_map(
        lambda a: col.all_reduce(mesh, a, rules.get("batch")), rows)


def scatter_row(cache, row, slot: int, global_batch: int) -> None:
    """Write ``row`` (``slice_row``'s) back into slot ``slot``: nothing to
    do for views; the owner copies it in where the batch is split."""
    owner = _owner(active_context(), slot, global_batch)
    if owner is None or not owner[2]:
        return
    local = owner[3]
    ops.tree_zip(lambda full, r: full[:, local:local + 1].copy_(r), cache, row)


def _owner(ctx, slot: int, global_batch: int):
    if ctx is None:
        return None
    mesh, rules = ctx
    axes = rules.get("batch")
    n = mesh.size(axes)
    if n <= 1 or global_batch % n:
        return None
    per = global_batch // n
    return mesh, rules, mesh.index(axes) == slot // per, slot % per


def make_layered_step_fn(model: DecoderModel, *, group: tuple,
                         prefill_len: int, global_batch: int,
                         cache_len: int, moe_dispatch: str = "dense",
                         dropless: bool = False):
    """The paper's fused iteration: decode one token for the whole batch
    across ALL blocks while prefilling ``prefill_len`` tokens of one
    request through blocks [group[0], group[1]) over slot 0's cache row
    (boundary activations in and out: the layered-prefill carry).  Under a
    sharding context ``batch["hidden"]`` and the returned ``h_out`` are
    this rank's block of the (1, prefill_len, d) residual."""
    b0, b1 = group

    def layered_step(params, cache, batch):
        logits, cache, aux = model.forward(
            params, batch["tokens"], cache=cache, offset=batch["offsets"],
            valid=batch["valid"][:, None], moe_dispatch=moe_dispatch,
            dropless=dropless, last_only=True, global_batch=global_batch,
            cache_len=cache_len)
        hidden = batch["hidden"]
        dev = hidden.device
        positions = torch.arange(prefill_len, device=dev)[None]
        offset = torch.zeros((1,), dtype=torch.int32, device=dev)
        row = slice_row(cache, 0, global_batch)
        h_out, row, auxes = model.run_blocks(
            params, hidden, b0, b1 - b0, positions=positions, offset=offset,
            cache=row, moe_dispatch=moe_dispatch, dropless=dropless,
            global_batch=1, cache_len=cache_len)
        scatter_row(cache, row, 0, global_batch)
        aux = dict(aux, prefill_expert_counts=torch.stack(
            [a["expert_counts"] for a in auxes]))
        return gather_vocab(model.cfg, logits[:, -1]), h_out, cache, aux
    return layered_step
