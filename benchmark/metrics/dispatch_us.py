"""The median over the (untraced) window's requests of the host span from
a request's first call into the program until its last call returns,
before the synchronise (the benchmark's own clock around its calls)."""

import statistics


def read(ctx):
    return statistics.median(ctx.dispatch_s) * 1e6
