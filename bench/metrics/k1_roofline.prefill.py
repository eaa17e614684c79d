"""Kernels: K1 (``moe_gmm_ragged``) in the prefill phase, its bound time
summed over its calls (``work.k1`` from the real assignments and
distinct experts) over its device time there, %."""

from bench.metrics._span import roofline


def read(ctx):
    return roofline(ctx, "prefill", "k1", "k1.prefill.bound_s")
