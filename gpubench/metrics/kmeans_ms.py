"""Device ms a batch of the k-means kernels of the channel-major path
(K3 warm start, K2 Lloyd pass with its partial sums, K4 maximin): the
kernels defined in these files of the program's csrc/, from the
profiler's trace."""

SOURCES = ("coarse_centers.cu", "lloyd_chw.cu", "maximin_chw.cu")


def read(ctx):
    return ctx.kernel_ms(SOURCES)
