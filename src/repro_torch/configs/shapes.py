"""The four input shapes of the multi-device dry-run, per-(arch, shape)
applicability, and the step inputs of each shape as tensors (a copy of the
JAX package's ``repro/configs/shapes.py``; the port's inputs are tensors,
fake ones under the dry-run's ``FakeTensorMode``).

Shapes:
  train_4k     seq=4096    global_batch=256   (training step)
  prefill_32k  seq=32768   global_batch=32    (inference prefill)
  decode_32k   seq=32768   global_batch=128   (one decode token, 32k KV)
  long_500k    seq=524288  global_batch=1     (long-context decode)

``long_500k`` needs sub-quadratic attention: it runs for the SSM/hybrid
archs (xlstm, recurrentgemma) and sliding-window variants, and is skipped
for full-attention archs.  ``applicable`` returns (ok, reason).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import torch_dtype
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}

# archs with sub-quadratic token mixing (bounded attention state)
_SUBQUADRATIC = {"recurrentgemma-9b", "xlstm-1.3b"}


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    if shape.name == "long_500k":
        if cfg.name in _SUBQUADRATIC or cfg.sliding_window:
            return True, ""
        return False, ("full quadratic attention at 524k context — skipped "
                       "per DESIGN.md §Shape skips (run for SSM/hybrid and "
                       "sliding-window variants)")
    return True, ""


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    if shape.kind in ("prefill", "decode"):
        # VLM backbones prepend n_patches stub patch embeddings to the text
        # tokens: the KV cache covers them too
        return shape.seq_len + cfg.vision.n_patches
    return 0


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch: Optional[int] = None, device="cpu") -> dict:
    """Uninitialised tensors for every input of the step of this (arch,
    shape), ``batch`` rows (default the global batch): under a
    ``FakeTensorMode`` they allocate nothing."""
    b = shape.global_batch if batch is None else batch
    s = shape.seq_len
    dt = torch_dtype(cfg.dtype)
    i32 = torch.int32
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = torch.empty((b, s), dtype=i32, device=device)
        specs["targets"] = torch.empty((b, s), dtype=i32, device=device)
        specs["mask"] = torch.empty((b, s), dtype=torch.bool, device=device)
        if cfg.encoder.enabled:
            specs["enc_out"] = torch.empty((b, cfg.encoder.n_frames,
                                            cfg.d_model), dtype=dt,
                                           device=device)
    elif shape.kind == "prefill":
        specs["tokens"] = torch.empty((b, s), dtype=i32, device=device)
        if cfg.encoder.enabled:
            specs["enc_out"] = torch.empty((b, cfg.encoder.n_frames,
                                            cfg.d_model), dtype=dt,
                                           device=device)
        if cfg.vision.enabled:
            specs["extra_embeds"] = torch.empty((b, cfg.vision.n_patches,
                                                 cfg.d_model), dtype=dt,
                                                device=device)
    else:  # decode
        specs["tokens"] = torch.empty((b, 1), dtype=i32, device=device)
        specs["offsets"] = torch.empty((b,), dtype=i32, device=device)
    return specs
