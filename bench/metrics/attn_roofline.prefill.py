"""Kernels: K2 (``prefill_attention``), its bound time summed over its calls
(``work.attention`` over the valid query and key counts) over its
device time, %."""

from bench.metrics._span import roofline


def read(ctx):
    return roofline(ctx, "prefill", "k2", "attn.prefill.bound_s")
