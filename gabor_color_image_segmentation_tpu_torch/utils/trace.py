"""Spans and host syncs on the profiler's clock.

``span(name)`` names a stage of the program for ``torch.profiler``: while a
profiler records, it opens ``record_function("gcis." + name)``, a range the
profiler stamps on the same timeline as the card's kernels and copies, so
each idle gap and each launch can be set against the stage that was
running on the host. With no profiler recording it costs one read of the
profiler's flag and records nothing.

``sync(site, read, *args)`` makes a host read of a device value that the
caller needs (``bool``, ``Tensor.item``, ``Tensor.cpu``, a blocking
upload): ``read(*args)``, the same with the profiler on or off, so results
are bit-equal either way. While a profiler records, the read runs inside
``span("sync." + site)``, and the count of ``gcis.sync.*`` ranges in a
trace is the number of host syncs the program made.

The profiler is the one switch: there is no span store, exporter or
setting here.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

PREFIX = "gcis."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager: ``record_function("gcis." + name)`` while a
    profiler records, else one that does nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _OFF


def sync(site: str, read, *args):
    """``read(*args)``, inside ``span("sync." + site)`` while a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return read(*args)
    with _profiler.record_function(PREFIX + "sync." + site):
        return read(*args)
