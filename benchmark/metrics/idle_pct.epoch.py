"""Share of the traced window of epochs in which the card ran nothing, in %."""


def read(ctx):
    if ctx["entry"] != "progressive":
        return None
    s = ctx["trace"]
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
