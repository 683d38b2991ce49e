"""95th percentile (nearest rank) of every batch's host-to-host time in
the window, from the call with host frames to its labels in host memory
(host clock)."""


def read(ctx):
    w = ctx.window
    return None if w is None or not w.times else w.batch_ms(0.95)
