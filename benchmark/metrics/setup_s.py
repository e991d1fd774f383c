"""Set-up: from the process's start to the window's (imports, the kernel
build on a checkout's first run, the driver's inputs and program objects,
the warm request)."""


def read(ctx):
    return ctx.setup_s
