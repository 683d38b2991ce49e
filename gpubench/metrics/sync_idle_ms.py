"""Device idle ms a batch in the gaps that begin while one of the
program's ``gcis.sync.*`` spans is open, each up to the next device
event: the queue drained for a host read, then the card waiting for the
host's next launch (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.sync_idle_ms(ctx.trace)
