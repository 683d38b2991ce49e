"""Device ms a batch of the GMM's kernels: its k-means init (K6 maximin,
K5 Lloyd), the precision Cholesky (K9, K10) and the EM pass (K8 with its
block-ordered sum from common.cuh), found by name in the profiler's
trace."""

SOURCES = ("maximin_t.cu", "lloyd_t.cu", "precision_chol.cu", "em_pass.cu", "common.cuh")


def read(ctx):
    return ctx.kernel_ms(SOURCES)
