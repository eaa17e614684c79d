"""PyTorch/CUDA port of the layered-prefill serving system.

A package of its own beside the JAX reference package ``repro``: it
imports ``torch`` (never ``jax``) and nothing from ``repro``; the
framework-free modules it needs (configs, schedulers, the KV allocator,
the serving loop) are copies kept at the same relative paths.  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on the
card the attention and MoE hot paths run hand-written Hopper kernels
(``repro_torch/kernels``)."""
