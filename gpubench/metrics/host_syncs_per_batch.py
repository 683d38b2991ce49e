"""Host syncs a batch: the program's ``gcis.sync.*`` spans in the traced
window (each a host read of a device value, or the blocking upload of
pageable frames) over its batches (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    n = spans.sync_count(ctx.trace)
    return None if n is None else n / ctx.trace.batches
