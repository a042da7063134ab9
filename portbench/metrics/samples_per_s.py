"""Image views through the train step over the whole window: the views of
every completed step over the time from the window's start to the end of
its last step (host clock, after a synchronisation at both ends)."""


def read(ctx):
    return ctx["views"] / ctx["window_s"]
