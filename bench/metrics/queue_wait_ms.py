"""Runtime: mean time from a request's scheduled arrival to its
admission, over the window's arrivals (to the window's end where it was
not admitted), ms."""


def read(ctx):
    w = ctx["queue_waits"]
    return 1e3 * sum(w) / len(w) if w else None
