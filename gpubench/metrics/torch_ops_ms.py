"""Device ms a batch of every kernel the program's csrc/ does not define
(PyTorch's own: the colour transform, the assembly and standardisation,
the EM's glue, casts, cuBLAS and cuSOLVER), memcpys and memsets apart,
from the profiler's trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    seconds, n = tr.kernel_seconds(exclude=ctx.pattern())
    return 1e3 * seconds / tr.batches if n else None
