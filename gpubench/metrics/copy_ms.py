"""Device ms a batch of the host <-> device copies (HtoD: the frames'
upload in models/pipeline.py::_prepare; DtoH: the labels' download and
the program's own small reads), from the profiler's trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.batches:
        return None
    seconds, n = tr.copy_seconds(("HtoD", "DtoH"))
    return 1e3 * seconds / tr.batches if n else None
