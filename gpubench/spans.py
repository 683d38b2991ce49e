"""The program's own spans in a traced window: the ``gcis.*`` ranges that
the program's ``utils/trace.py`` opens while a profiler records (the
chrome trace's ``user_annotation`` events, on the clock of the device's
events), read from what ``trace.Trace`` holds: its host events, its
runtime events and its device events.

Device time is charged to the span that launched it: a kernel, memcpy or
memset belongs to a span when the runtime call that enqueued it (the
runtime event of the same ``args.correlation``) started inside a range of
that span, wherever the queue let the device run it. Stages nest by time
on the one host thread. A trace that holds no ``gcis.`` span (a program
without them) or no device event (the CPU) reads nothing: every function
that returns a metric returns None there.
"""

from __future__ import annotations

import bisect

from gpubench import trace

PREFIX = "gcis."
SEGMENT = PREFIX + "segment"
SYNC = PREFIX + "sync."


def _ranges(tr, match) -> list:
    """Sorted (start, end) of the program's spans whose name ``match``
    accepts, in microseconds."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in tr.host
                  if e.get("cat") == "user_annotation" and match(e["name"]))


def readable(tr) -> bool:
    """A trace with batches, device events and at least one program span."""
    return bool(tr is not None and tr.batches and tr.device
                and _ranges(tr, lambda n: n.startswith(PREFIX)))


def _covered(t: float, merged: list) -> bool:
    """Whether t lies in one of the disjoint, sorted ranges [s, e)."""
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t < merged[i][1]


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two sets of disjoint, sorted ranges."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def sync_count(tr) -> int | None:
    """The ``gcis.sync.*`` spans in the window."""
    if not readable(tr):
        return None
    return len(_ranges(tr, lambda n: n.startswith(SYNC)))


def launched_ms(tr, names) -> float | None:
    """Device ms a batch of the kernels, memcpys and memsets whose launch
    started inside a span named in ``names``; None where no such span
    ran."""
    if not readable(tr):
        return None
    names = {PREFIX + n for n in names}
    ranges = trace.merge(_ranges(tr, names.__contains__))
    if not ranges:
        return None
    launched = {e["args"]["correlation"] for e in tr.runtime
                if "correlation" in e.get("args", {}) and _covered(float(e["ts"]), ranges)}
    us = sum(float(e["dur"]) for e in tr.device
             if e.get("args", {}).get("correlation") in launched)
    return us / 1e3 / tr.batches


def host_enqueue_ms(tr) -> float | None:
    """Host ms a batch inside ``gcis.segment`` and outside every
    ``gcis.sync.*`` span: the program's own host work, the waits at its
    syncs left out."""
    if not readable(tr):
        return None
    segments = trace.merge(_ranges(tr, SEGMENT.__eq__))
    if not segments:
        return None
    syncs = trace.merge(_ranges(tr, lambda n: n.startswith(SYNC)))
    us = sum(e - s for s, e in segments) - _overlap(segments, syncs)
    return us / 1e3 / tr.batches


def sync_idle_ms(tr) -> float | None:
    """Device idle ms a batch in the gaps that begin while a
    ``gcis.sync.*`` span is open, each up to the next device event (or
    the window's end): what the syncs' drains cost the card."""
    if not readable(tr):
        return None
    syncs = trace.merge(_ranges(tr, lambda n: n.startswith(SYNC)))
    busy = trace.merge((max(float(e["ts"]), tr.t0), min(float(e["ts"]) + float(e["dur"]), tr.t1))
                       for e in tr.device)
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    us = sum(e - s for s, e in zip(edges[0::2], edges[1::2])
             if e > s and _covered(s, syncs))
    return us / 1e3 / tr.batches
