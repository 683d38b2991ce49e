"""Device ms a batch of the kernels, memcpys and memsets launched inside
the program's ``gcis.gmm_init`` span: the GMM's k-means init (K6 maximin,
K5 Lloyd), its hard moments and the first parameters (gpubench/spans.py)."""

from gpubench import spans


def read(ctx):
    return spans.launched_ms(ctx.trace, ("gmm_init",))
