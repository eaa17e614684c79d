"""Model: device time of the kernels launched inside
``Engine._prefill_impl`` (the ``bench.prefill`` span), per iteration,
ms."""

from bench.metrics._span import device_ms_per_iter


def read(ctx):
    return device_ms_per_iter(ctx, "prefill")
