"""Engine: the window's seconds per engine iteration, ms."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["iterations"] \
        if ctx["iterations"] else None
