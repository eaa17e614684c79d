"""Train a ~100M-parameter MiniCPM-family model for a few hundred steps on
the synthetic corpus with the WSD schedule (MiniCPM's signature), with
checkpointing, and verify the loss drops — the PyTorch port of
``examples/train_small.py``.  On the card attention runs the hand-written
prefill kernel and its backward kernel; ``--device cpu`` runs their plain
versions.

Run:  PYTHONPATH=src python examples/train_small_torch.py [--steps 300]
          [--device cpu] [--ckpt path.pt]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import DecoderModel
from repro_torch.training.data import PackedDataset, SyntheticCorpus
from repro_torch.training.optimizer import adamw, tree_leaves
from repro_torch.training.train import Trainer

# checkpoints stay inside the checkout, in the directory .gitignore lists
DEFAULT_CKPT = Path(__file__).resolve().parents[1] / "build" / "minicpm100m.pt"


def small_minicpm():
    """MiniCPM-2B scaled to ~100M params (keeps family structure: deep/thin,
    MHA, SwiGLU, tied embeddings)."""
    cfg = get_config("minicpm-2b")
    return dataclasses.replace(
        cfg, name="minicpm-100m", n_layers=8, d_model=512, n_heads=8,
        n_kv_heads=8, head_dim=64, d_ff=1536, vocab_size=8192,
        max_seq_len=512).validate()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)

    cfg = small_minicpm()
    model = DecoderModel(cfg, device=args.device)
    params = model.init_params(
        torch.Generator(device=model.device).manual_seed(0))
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"{cfg.name}: {n_params / 1e6:.1f}M params, "
          f"{cfg.n_layers}L d={cfg.d_model} on {model.device}")

    opt = adamw(lr=6e-4, schedule="wsd", total_steps=args.steps, warmup=20)
    trainer = Trainer(model=model, opt=opt, params=params)
    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
    ds = PackedDataset(corpus, seq_len=args.seq, batch_size=args.batch,
                       seed=0)
    Path(args.ckpt).parent.mkdir(parents=True, exist_ok=True)
    hist = trainer.fit(iter(ds), steps=args.steps, log_every=20,
                       checkpoint_path=args.ckpt, checkpoint_every=100)
    for rec in hist:
        print(f"  step {rec['step']:>4}  loss {rec['ce']:.3f}  "
              f"lr {rec['lr']:.2e}  wall {rec['wall']:.0f}s")
    first, last = hist[0]["ce"], hist[-1]["ce"]
    print(f"\nloss: {first:.3f} -> {last:.3f} "
          f"({'OK' if last < first - 0.5 else 'NO IMPROVEMENT'})")
    if os.path.exists(args.ckpt):
        print(f"checkpoint: {args.ckpt} "
              f"({os.path.getsize(args.ckpt) / 1e6:.0f} MB)")


if __name__ == "__main__":
    main()
