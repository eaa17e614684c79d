"""Scheduler: the increase of ``Engine.expert_load_bytes`` (the paper's
expert-union count a block and an iteration) over the window, per
iteration, MB."""


def read(ctx):
    return ctx["expert_bytes"] / ctx["iterations"] / 1e6 \
        if ctx["iterations"] else None
