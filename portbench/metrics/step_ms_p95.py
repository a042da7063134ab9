"""95th percentile (nearest rank) of the window's step times: the gaps
between consecutive step-boundary CUDA events on the stream, epoch-end
stalls included."""
import math


def read(ctx):
    times = sorted(ctx["step_s"])
    if not times:
        return None
    return 1e3 * times[max(math.ceil(0.95 * len(times)) - 1, 0)]
