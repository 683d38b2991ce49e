"""Share of the traced window in which no kernel, memcpy or memset ran
on the card: 100 (1 - the union of the device intervals / the window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
