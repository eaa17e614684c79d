"""Kernels: K3 (``decode_attention``), its bound time summed over its calls
(``work.attention`` over the valid query and key counts) over its
device time, %."""

from bench.metrics._span import roofline


def read(ctx):
    return roofline(ctx, "decode", "k3", "attn.decode.bound_s")
