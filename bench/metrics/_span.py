"""Shared arithmetic of the trace readers."""

from bench import work


def device_ms_per_iter(ctx, phase):
    s = ctx.get("trace", {}).get("span_device_s", {}).get((phase, "all"))
    return 1e3 * s / ctx["iterations"] if s and ctx["iterations"] else None


def roofline(ctx, phase, kernel, bound_key):
    """Summed bound seconds of the phase's calls over the device time of
    the kernels launched inside them, %."""
    t = ctx.get("trace", {}).get("span_device_s", {}).get((phase, kernel))
    b = ctx.get("work", {}).get(bound_key)
    return 100.0 * b / t if t and b else None


def mfu(ctx, phase):
    f = ctx.get("work", {}).get(f"model.{phase}.flops")
    return 100.0 * f / (ctx["window_s"] * work.PEAK_FLOPS) if f else None
