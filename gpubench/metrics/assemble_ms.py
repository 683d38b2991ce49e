"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.assemble`` and ``gcis.assemble_xp`` spans (the
colour rows, the 2x2 pools, the standardisation affine, the coarse
buffer), wherever the queue let them run (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("assemble", "assemble_xp"))
