"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.em_refine`` span: the full-resolution EM passes and
the labels-only pass (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("em_refine",))
