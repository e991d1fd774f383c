"""All the hashes that the window's requests completed, over the whole window."""


def read(ctx):
    return ctx.work["hashes"] / ctx.window_s
