"""Device and dtype resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU.  Without CUDA a run that did not ask for the CPU raises —
    it never continues on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device`` without a host sync: a CUDA
    destination is filled from pinned memory with a non-blocking copy (a
    blocking copy from pageable memory would wait for the card's queue)."""
    t = torch.from_numpy(np.array(a))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype name (``ModelConfig.dtype`` / ``param_dtype``) to a
    torch dtype."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; known: {list(_DTYPES)}")
    return _DTYPES[name]
