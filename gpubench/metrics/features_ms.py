"""Device ms a batch of the Gabor energies kernel (K1): the kernels
defined in the program's csrc/gabor_energies.cu, found by name in the
profiler's trace."""

SOURCES = ("gabor_energies.cu",)


def read(ctx):
    return ctx.kernel_ms(SOURCES)
