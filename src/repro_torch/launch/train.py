"""Training launcher of the port: the JAX package's ``launch/train.py`` on
one device — the synthetic data pipeline, the train step on torch
autograd (K2 and K4 with their hand-written backward kernels on the card),
AdamW under the WSD (default), cosine or constant schedule, and an optional
checkpoint.

The model runs at its full configured width and depth (``--smoke`` selects
the reduced variant) with random weights from seed 0, or the parameters of
a checkpoint (``--init``: a file ``training.checkpoint.save`` wrote, such as
one ``--ckpt`` wrote, or the JAX package's parameters converted through
``repro_torch.convert``).  Activation checkpointing per block (``remat``)
is on unless ``--smoke``, as in the JAX launcher.  It prints the JAX
launcher's ``[train]`` lines with the device in place of the mesh; a
logged step reads its metrics back in one transfer, other steps read
nothing.  Multi-device training (``--production-mesh``, the train_4k
step over the production mesh) is the next slice of the multi-device
port; the serve steps already shard (``launch/steps.py``,
``launch/dryrun.py``).

Usage:
  # on the card, full minicpm-2b (2.7 B parameters), 8 x 256 tokens a step:
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \\
      --steps 50

  # on the CPU, reduced model (the kernels' plain versions run):
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 3 [--batch 8] [--seq 256] [--ckpt /path/ck.pt]
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config, list_configs
from repro_torch.kernels import ops
from repro_torch.models.model import DecoderModel
from repro_torch.training import checkpoint as ckpt_io
from repro_torch.training.data import PackedDataset, SyntheticCorpus
from repro_torch.training.optimizer import adamw, tree_leaves
from repro_torch.training.train import (device_batch, make_train_step,
                                        read_metrics)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b", choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=6e-4)
    ap.add_argument("--schedule", default="wsd",
                    choices=["wsd", "cosine", "const"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh of the JAX launcher: not yet "
                         "ported for training")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    ap.add_argument("--init", default=None,
                    help="start from the 'params' of this checkpoint")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.production_mesh:
        raise SystemExit("--production-mesh: multi-device training is not "
                         "ported yet (the next slice of the multi-device "
                         "port); the port trains on one device")
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    model = DecoderModel(cfg, device=args.device, remat=not args.smoke)
    dev = model.device
    opt = adamw(lr=args.lr, schedule=args.schedule, total_steps=args.steps,
                warmup=max(args.steps // 10, 1))
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.init:
        params = ckpt_io.restore(args.init, {"params": params})["params"]
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, cfg.encoder.enabled)

    n = sum(p.numel() for p in tree_leaves(params))
    print(f"[train] {cfg.name}: {n / 1e6:.1f}M params on device {dev}"
          f"{' (' + torch.cuda.get_device_name(dev) + ')' if dev.type == 'cuda' else ''}")

    corpus = SyntheticCorpus(vocab_size=cfg.vocab_size, seed=0)
    ds = iter(PackedDataset(corpus, seq_len=args.seq,
                            batch_size=args.batch, seed=0))
    ops.reset_launches()
    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = device_batch(model, *next(ds))
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == 1:
            m = read_metrics({"loss": metrics["loss"], "lr": metrics["lr"]})
            print(f"[train] step {step:>5} loss={m['loss']:.3f} "
                  f"lr={m['lr']:.2e} "
                  f"({(time.time() - t0) / step:.2f}s/step)")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        print("[train] kernel launches: " + ", ".join(
            f"{k} {v}" for k, v in ops.LAUNCHES.items() if v))
    if args.ckpt:
        ckpt_io.save(args.ckpt, {"params": params, "opt": opt_state})
        print(f"[train] checkpoint -> {args.ckpt}")


if __name__ == "__main__":
    main()
