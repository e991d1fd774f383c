"""The share of the traced window in which no kernel, copy or set ran on
the device: 100 (1 - busy / window), busy the union of their intervals."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
