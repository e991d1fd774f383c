"""The 95th percentile (nearest rank) over every request of the window of
its time from issue to its synchronised result."""

import math


def read(ctx):
    lat = sorted(ctx.latencies_s)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
