"""Megapixels whose labels reached host memory, over the whole window's
seconds: all the batches over all the time (host clock)."""


def read(ctx):
    w = ctx.window
    return None if w is None or not w.pixels else w.mp_s()
