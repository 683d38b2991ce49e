"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.em_fit`` span: the ``n_iter`` EM iterations on the
fit grid (K9 or K10, K8 with moments, the parameter glue and the per-image
tol freeze; gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("em_fit",))
