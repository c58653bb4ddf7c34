"""Device operations (kernels, copies, sets) a Whitted frame: the ladder's
levels, compaction and delivery (ops/trace.py), a count."""


def read(ctx):
    if ctx["entry"] != "whitted":
        return None
    return ctx["trace"]["device_ops"] / ctx["units"]
