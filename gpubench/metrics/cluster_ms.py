"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.coarse``, ``gcis.mid`` and ``gcis.cluster`` spans:
the k-means kernels and the Lloyd loop's centre updates and fixed-point
tests, wherever the queue let them run (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("coarse", "mid", "cluster"))
