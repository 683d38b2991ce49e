"""Device-resident MP/s (gpubench/resident.py, the program's
benchmark.py::bench_device measure copied): the batch uploaded once, each
call's labels summed on the card, one fence; run before the profiler
starts (host clock around the fenced loop)."""


def read(ctx):
    return ctx.resident_mp_s
