"""Kernel-launch API calls (cudaLaunchKernel, cudaLaunchKernelExC, ...)
the host made in the traced window, over its batches: the host
orchestration's cost in launches (profiler trace, runtime events)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    n = tr.launches()
    return n / tr.batches if n else None
