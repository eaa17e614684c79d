"""Whole step: the model FLOPs of the prefill phase's tokens (matrix
products, attention over each token's context, the LM head where a token
is emitted) over the window's seconds times the bf16 peak, %."""

from bench.metrics._span import mfu


def read(ctx):
    return mfu(ctx, "prefill")
