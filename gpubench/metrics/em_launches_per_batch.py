"""Kernel-launch API calls (cudaLaunchKernel, cudaLaunchKernelExC, ...)
whose start lies inside the program's ``gcis.gmm_init``, ``gcis.em_fit``
or ``gcis.em_refine`` spans, over the traced batches: what the EM loop
costs the host in launches (profiler trace, runtime events). None where
no EM span ran."""

from gpubench import spans, trace

NAMES = ("gmm_init", "em_fit", "em_refine")


def read(ctx):
    tr = ctx.trace
    if not spans.readable(tr):
        return None
    names = {spans.PREFIX + n for n in NAMES}
    ranges = trace.merge(spans._ranges(tr, names.__contains__))
    if not ranges:
        return None
    n = sum(1 for e in tr.runtime if trace._LAUNCH.match(e.get("name", ""))
            and spans._covered(float(e["ts"]), ranges))
    return n / tr.batches
