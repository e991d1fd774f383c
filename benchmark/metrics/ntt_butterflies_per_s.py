"""All the butterflies that the window's requests completed, over the whole window."""


def read(ctx):
    return ctx.work["butterflies"] / ctx.window_s
