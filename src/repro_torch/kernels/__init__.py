"""Hand-written Hopper kernels (csrc/), their plain PyTorch versions
(ref.py) and the wrappers the model calls (ops.py)."""
