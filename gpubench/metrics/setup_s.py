"""Seconds from the process's start to the window's: imports, the
kernels' build or load, the frames, the warm-up batches (host clock)."""


def read(ctx):
    return ctx.setup_s
