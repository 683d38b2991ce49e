"""Host ms a batch inside the program's ``gcis.segment`` span and outside
every ``gcis.sync.*`` span in it: the Python, dispatch and launches of
one call, its waits at the syncs left out (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.host_enqueue_ms(ctx.trace)
