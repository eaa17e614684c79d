"""Engine: device-to-host syncs torch's sync debug mode reports in the
window, per iteration."""


def read(ctx):
    if ctx.get("syncs") is None or not ctx["iterations"]:
        return None
    return ctx["syncs"] / ctx["iterations"]
