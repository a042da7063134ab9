"""100 - the union of device events (kernels, copies, sets) over the traced
stretch's length, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not tr["busy_us"] or not tr["span_us"]:
        return None
    return 100.0 * (1.0 - tr["busy_us"] / tr["span_us"])
