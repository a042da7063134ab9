"""Process start to the window's start (host clock): imports, data and
weights from the seed, the trainer, kernel loads, the checked and warm-up
steps at the cell's shapes."""


def read(ctx):
    return ctx["setup_s"]
