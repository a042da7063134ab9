"""`torch.cuda.max_memory_allocated()` over the window, reset at its start, in GiB."""


def read(ctx):
    if ctx["peak_bytes"] is None:
        return None
    return ctx["peak_bytes"] / 2 ** 30
