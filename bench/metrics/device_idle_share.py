"""Device: the share of the traced window in which no device operation
runs (the union of their intervals from ``torch.profiler``, not their
sum), %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
