"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.color`` span (uint8 to float, sRGB to CIELab),
wherever the queue let them run (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("color",))
