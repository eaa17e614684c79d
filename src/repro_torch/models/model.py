"""DecoderModel: the model runtime of the port.

Two execution paths over the same block definitions:

- ``forward``: the full stack, a Python loop over blocks (the JAX
  package's ``lax.scan`` over segments has no counterpart PyTorch needs).
- ``run_blocks(start, n)``: blocks [start, start+n) with boundary
  activations in and out — the primitive layered prefill schedules over.

Parameters are a plain dict with the JAX package's structure and layouts:
``params["segments"][s]["pattern"][p]`` holds one block's parameters
stacked over the segment's repeats (leading axis ``reps``).  Caches mirror
it: ``cache[s][p]`` is ``{"k", "v"}`` of shape (reps, batch, S_max, Hkv,
hd), or MLA's ``{"ckv", "kr"}`` of shape (reps, batch, S_max, width), or
a recurrent mixer's state, which has no position axis: RG-LRU's
``{"conv", "h"}``, mLSTM's ``{"C", "n", "m", "conv"}``, sLSTM's ``{"c",
"n", "h", "m"}``, each (reps, batch, ...).  ``recurrent[s][p]`` says which
blocks hold state rather than KV rows.  A stack with a dense first block
has two segments once it is deeper than the 16-block period search
(deepseek-v2-236b at full depth: 1 + 59).  Cache updates happen in place
(see models/attention.py, models/rglru.py, models/xlstm.py).

Whisper's encoder-decoder: ``params["encoder"]`` holds the encoder's
blocks as an unstacked list and its final norm; ``encode`` runs it
(bidirectional self-attention) over precomputed frame embeddings, and
``precompute_cross_kv`` projects its output to each decoder block's cross
K/V, which the cache keeps in ``xk``/``xv`` of shape (reps, batch,
n_frames, Hkv, hd): a frame axis, which moves whole where positions move
in part (``whole_leaf``).  Qwen2-VL's vision stub prepends patch
embeddings in ``embed``; its M-RoPE gets three equal position planes.

Under a ``sharding_context`` (``sharding/partition.py``) ``forward`` and
``run_blocks`` run as one rank of the mesh over its shards
(``convert.shard_params``, ``partition.cache_specs``): tokens, offsets
and caches are the rank's rows, ``global_batch`` and ``cache_len`` name
the call's global rows and cache length, the residual lies between
blocks as ``sharding/spmd.py`` lays it (rows over the batch axes, the
sequence over ``model`` where they divide), and the logits are the
rank's vocab columns.  Every width a block reshapes by (heads, kv heads,
F, vocab) is read from the rank's shards.  ``encode`` and
``precompute_cross_kv`` take ``global_batch`` there too: the encoder's
residual lies as ``spmd.layout`` lays it (1500 frames divide over neither
8 nor 16 ranks, so whisper-base's stays whole over ``model``), its output
is the rank's rows whole over ``model``, and the cross K/V come out in
the cross cache's layout.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention, blocks, layers
from repro_torch.models.config import BlockSpec, ModelConfig
from repro_torch.sharding import spmd
from repro_torch.sharding.partition import (active_context, shard_seq_hint,
                                            sharding_context)

Tensor = torch.Tensor


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _in_context(fn, ctx):
    """``fn`` run inside the sharding context ``ctx`` (or none): the
    recompute of a checkpointed block runs in the backward pass, on
    autograd's device thread for CUDA tensors, where the caller's
    thread-local context is not installed."""
    if ctx is None:
        return fn

    def run(*args):
        with sharding_context(*ctx):
            return fn(*args)
    return run


def sinusoidal_positions(n: int, d: int, device) -> Tensor:
    """The encoder's fixed positions (n, d): sin at even, cos at odd
    channels, at angles pos / 10000^(2i / d)."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


# the encoder's blocks: bidirectional GQA self-attention and a dense MLP
ENCODER_SPEC = BlockSpec(mixer="gqa", ffn="dense")


class DecoderModel:
    def __init__(self, cfg: ModelConfig, device=None, remat: bool = False):
        """``device`` defaults to ``cuda`` (raises without CUDA); pass
        ``"cpu"`` to run the plain versions on the CPU.  ``remat``: run
        each block without a cache under activation checkpointing
        (``torch.utils.checkpoint``, non-reentrant), so the backward pass
        recomputes its activations — the JAX package's ``jax.checkpoint``
        per block, which its training launcher turns on."""
        self.cfg = cfg.validate()
        self.remat = remat
        self.device = resolve_device(device)
        self.specs = cfg.block_specs()
        self.segments = cfg.scan_segments()
        self.index_map = cfg.block_index_map()
        self.n_blocks = cfg.n_layers
        # per segment and pattern position: True where the block's cache
        # is recurrent state (no position axis) rather than KV rows
        self.recurrent = [[sp.is_recurrent() for sp in pattern]
                          for pattern, _ in self.segments]

    # -- init ---------------------------------------------------------------

    def init_params(self, generator: Optional[torch.Generator] = None) -> dict:
        """Random parameters with the JAX package's distributions (normal x
        1/sqrt(fan_in); 0.02 for router and embeddings; RG-LRU's
        ``a_param`` and the xLSTM gate biases as in models/rglru.py and
        models/xlstm.py), drawn directly in
        ``param_dtype`` on the model's device from ``generator`` (a
        ``torch.Generator`` on that device; seed 0 when omitted)."""
        cfg, dev = self.cfg, self.device
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params: dict = {"embed": layers.init_embed(cfg, dev, generator),
                        "final_norm": layers.init_norm(cfg, dev)}
        params["segments"] = [
            {"pattern": [blocks.init_block(cfg, sp, dev, generator, reps=reps)
                         for sp in pattern]}
            for pattern, reps in self.segments]
        if cfg.encoder.enabled:
            params["encoder"] = {
                "blocks": [blocks.init_block(cfg, ENCODER_SPEC, dev, generator)
                           for _ in range(cfg.encoder.n_layers)],
                "final_norm": layers.init_norm(cfg, dev)}
        return params

    def init_cache(self, batch: int, max_len: int, dtype=None) -> list:
        """Zeroed KV rows and recurrent state at its init values (the
        stabilizers' -1e30 included), repeated over each segment's reps."""
        dt = dtype or torch_dtype(self.cfg.dtype)
        cache = []
        for pattern, reps in self.segments:
            seg = []
            for sp in pattern:
                c = blocks.init_block_cache(self.cfg, sp, batch, max_len,
                                            self.device, dt)
                seg.append({k: v[None].repeat((reps,) + (1,) * v.dim())
                            for k, v in c.items()})
            cache.append(seg)
        return cache

    def whole_leaf(self, s: int, p: int, key: str) -> bool:
        """Whether cache leaf ``key`` of block (segment ``s``, pattern
        position ``p``) moves whole in a copy of a slot: recurrent state
        and the cross K/V (a frame axis), against the positions ``[0, n)``
        of a KV row."""
        return self.recurrent[s][p] or key in attention.CROSS_LEAVES

    # -- encoder (whisper) ---------------------------------------------------

    def encode(self, params, frames: Tensor,
               global_batch: Optional[int] = None) -> Tensor:
        """frames (B, T, D), precomputed frame embeddings (the audio
        frontend is a stub) -> the encoder's output (B, T, D): fixed
        sinusoidal positions, then each block's bidirectional self-
        attention (prefill attention with ``causal=False``; the JAX
        package gets the same mask by giving every query the last
        position, which it passes here too) and MLP, then a final norm.
        Under a sharding context ``frames`` and the output are the rank's
        rows, whole over ``model`` (the module docstring)."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        b, t, _ = frames.shape
        x = frames.to(dt) + sinusoidal_positions(t, cfg.d_model,
                                                 frames.device).to(dt)
        full_pos = torch.full((b, t), t - 1, dtype=torch.long,
                              device=frames.device)
        lay = self._layout(global_batch, t, None)
        if lay is not None:
            x = shard_seq_hint(x, global_batch)
        for bp in params["encoder"]["blocks"]:
            h = layers.apply_norm(cfg, bp["ln1"], x)
            out, _ = attention.apply_gqa(cfg, ENCODER_SPEC, bp["attn"], h,
                                         positions=full_pos, causal=False,
                                         lay=lay)
            x = x + out
            h2 = layers.apply_norm(cfg, bp["ln2"], x)
            x = x + layers.apply_mlp(cfg, bp["mlp"], h2, lay=lay)
        if lay is not None:
            mesh, rules = active_context()
            x = spmd.gather_seq(mesh, rules, x, lay)
        return layers.apply_norm(cfg, params["encoder"]["final_norm"], x)

    def precompute_cross_kv(self, params, enc_out: Tensor) -> list:
        """Every cross-attention block's encoder K/V, in segment layout:
        ``out[s][p]`` is ``{"xk", "xv"}`` of shape (reps, B, T, Hkv, hd),
        or None for a block without cross-attention (under a sharding
        context the rank's rows and the cross cache's kv heads,
        ``attention.encode_cross_kv``)."""
        return [[dict(zip(attention.CROSS_LEAVES, attention.encode_cross_kv(
                     self.cfg, pp["attn"], enc_out)))
                 if sp.cross_attn else None
                 for sp, pp in zip(pattern, seg["pattern"])]
                for (pattern, _), seg in zip(self.segments,
                                             params["segments"])]

    def install_cross_kv(self, params, cache, enc_out: Tensor,
                         slot: Optional[int] = None) -> None:
        """Write the cross K/V of the encoder output ``enc_out`` into every
        cross-attention block's cache leaves, IN PLACE: every row, or with
        ``slot`` that slot's row from ``enc_out``'s one row (the engine's
        admission).  Under a sharding context the rank's rows and the
        cross cache's kv heads (``precompute_cross_kv``)."""
        for seg, seg_kv in zip(cache, self.precompute_cross_kv(params,
                                                               enc_out)):
            for c, kv in zip(seg, seg_kv):
                if kv is None:
                    continue
                for key in attention.CROSS_LEAVES:
                    if slot is None:
                        c[key].copy_(kv[key])
                    else:
                        c[key][:, slot].copy_(kv[key][:, 0])

    # -- embedding / head ----------------------------------------------------

    def embed(self, params, tokens: Tensor,
              extra_embeds: Optional[Tensor] = None,
              positions: Optional[Tensor] = None) -> Tensor:
        """Token embeddings (B, S, D); ``extra_embeds`` (B, N, D), the
        vision stub's patch embeddings, are prepended; with learned
        positions the table's rows at ``positions`` (clipped to the
        table) are added."""
        x = layers.embed_tokens(self.cfg, params["embed"], tokens)
        if extra_embeds is not None:
            x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
        if self.cfg.pos_emb == "learned" and positions is not None:
            idx = positions.long().clamp(0, self.cfg.max_seq_len - 1)
            x = x + params["embed"]["pos"][idx].to(x.dtype)
        return x

    def logits(self, params, x: Tensor) -> Tensor:
        x = layers.apply_norm(self.cfg, params["final_norm"], x)
        return layers.unembed(self.cfg, params["embed"], x)

    def _layout(self, global_batch: Optional[int], s: int,
                cache_len: Optional[int]):
        """The call's residual layout under a sharding context, else
        None."""
        ctx = active_context()
        if ctx is None:
            return None
        if global_batch is None:
            raise ValueError("under a sharding context forward and "
                             "run_blocks need global_batch")
        return spmd.layout(ctx[0], ctx[1], global_batch, s, cache_len)

    # -- execution -----------------------------------------------------------

    def param_shapes(self) -> dict:
        """The parameter tree at full size on fake tensors (shapes and
        dtypes, no memory): what the spec functions read."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        with FakeTensorMode():
            return DecoderModel(self.cfg, device="cpu").init_params(
                torch.Generator().manual_seed(0))

    def block_params(self, params, b: int) -> dict:
        s, r, p_idx = self.index_map[b]
        return _index(params["segments"][s]["pattern"][p_idx], r)

    def run_blocks(self, params, x: Tensor, start: int, n: int, *,
                   positions: Tensor, offset: Optional[Tensor] = None,
                   cache: Optional[list] = None,
                   enc_out: Optional[Tensor] = None,
                   valid: Optional[Tensor] = None, dropless: bool = False,
                   moe_dispatch: str = "ragged",
                   global_batch: Optional[int] = None,
                   cache_len: Optional[int] = None):
        """Run blocks [start, start+n) over x (B, S, D).  Returns (x', cache,
        aux-list-in-block-order); ``cache`` (leaves (reps, B, ...)) is
        updated in place.  Rows are independent: the engine's packed
        layer-group path runs every prefill slice sharing this block range
        as one batch, with per-row ``offset``/``valid`` masking and
        bucket-padded rows that are no-ops end to end.  Under a sharding
        context x is this rank's block of the residual, ``positions`` and
        ``valid`` its rows at every position."""
        lay = self._layout(global_batch, positions.shape[1], cache_len)
        auxes = []
        for b in range(start, start + n):
            s, r, p_idx = self.index_map[b]
            c = (_index(cache[s][p_idx], r) if cache is not None else None)
            fn = functools.partial(
                blocks.apply_block, self.cfg, self.specs[b],
                self.block_params(params, b), positions=positions,
                offset=offset, cache=c, enc_out=enc_out, valid=valid,
                dropless=dropless, moe_dispatch=moe_dispatch, lay=lay)
            if self.remat and cache is None:
                x, _, aux = checkpoint(_in_context(fn, active_context()), x,
                                       use_reentrant=False)
            else:
                x, _, aux = fn(x)
            auxes.append(aux)
        return x, cache, auxes

    def forward(self, params, tokens: Tensor, *,
                positions: Optional[Tensor] = None,
                offset: Optional[Tensor] = None,
                cache: Optional[list] = None,
                enc_out: Optional[Tensor] = None,
                extra_embeds: Optional[Tensor] = None,
                valid: Optional[Tensor] = None, dropless: bool = False,
                moe_dispatch: str = "ragged", last_only: bool = False,
                global_batch: Optional[int] = None,
                cache_len: Optional[int] = None,
                return_hidden: bool = False):
        """tokens (B, S) -> (logits (B, S', V) fp32, cache, aux) with
        ``aux["expert_counts"]`` of shape (L, E).  ``extra_embeds`` (B, N,
        D) are prepended (S' = N + S, at positions offset + arange(S'),
        whatever ``positions`` says: the JAX package's rule);
        ``enc_out`` (B, T, D) feeds every cross-attention block.
        ``last_only``: the logits of the last position only, (B, 1, V).
        Under a sharding context (see the module docstring) the logits are
        this rank's vocab columns.  ``return_hidden``: the last block's
        output (B, S, D) in place of the logits, before the final norm
        (under a context, this rank's block of the residual; the training
        loss takes the head from there, ``training/train.py``)."""
        b, s = tokens.shape
        dev = tokens.device
        if offset is None and cache is not None:
            offset = torch.zeros((b,), dtype=torch.int32, device=dev)
        base = offset.long() if offset is not None else torch.zeros(
            (b,), dtype=torch.long, device=dev)
        if extra_embeds is not None:
            positions = base[:, None] + torch.arange(
                s + extra_embeds.shape[1], device=dev)[None]
        elif positions is None:
            positions = base[:, None] + torch.arange(s, device=dev)[None]
        x = self.embed(params, tokens, extra_embeds, positions)
        lay = self._layout(global_batch, x.shape[1], cache_len)
        if lay is not None:
            # whole over model after the embedding: the residual's layout
            mesh, rules = active_context()
            x = shard_seq_hint(x, global_batch)
        x, cache, auxes = self.run_blocks(
            params, x, 0, self.n_blocks, positions=positions, offset=offset,
            cache=cache, enc_out=enc_out, valid=valid, dropless=dropless,
            moe_dispatch=moe_dispatch, global_batch=global_batch,
            cache_len=cache_len)
        aux = {
            "expert_counts": torch.stack([a["expert_counts"] for a in auxes]),
            "aux_loss": sum(a["aux_loss"] for a in auxes),
            "dropped": sum(a["dropped"] for a in auxes),
        }
        if return_hidden:
            return x, cache, aux
        if lay is not None:
            x = (spmd.gather_seq(mesh, rules, x[:, -1:], lay)[:, -1:]
                 if last_only else spmd.gather_seq(mesh, rules, x, lay))
        elif last_only:
            x = x[:, -1:]
        return self.logits(params, x), cache, aux
