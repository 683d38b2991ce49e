"""What a profiler trace says about the traced window: torch.profiler's
chrome trace (``export_chrome_trace``), read as data.

Device events are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
categories; the window is the harness's ``gpubench.window`` annotation;
host activity is every ``cpu_op``, ``cuda_runtime``, ``cuda_driver`` and
``user_annotation`` event. Times are microseconds in the trace and seconds
out of it.
"""

from __future__ import annotations

import bisect
import json
import re
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW = "gpubench.window"
BATCH = "gpubench.batch"
_LOOKBACK = 256  # host events searched back from a gap
_LAUNCH = re.compile(r"^cu(da)?LaunchKernel")
_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")


def kernel_names(paths) -> set:
    """The __global__ function names defined in the given source files."""
    names = set()
    for path in paths:
        names.update(_GLOBAL.findall(Path(path).read_text()))
    return names


def name_pattern(names):
    """A regex that finds a kernel of ``names`` in a demangled trace name
    (the function's own identifier, before its template or its
    arguments), or None for no names."""
    if not names:
        return None
    alt = "|".join(sorted(map(re.escape, names), key=len, reverse=True))
    return re.compile(r"(?<![\w])(?:" + alt + r")(?=\s*[<(])")


def short_name(name: str) -> str:
    """A kernel's identifier without its namespace, template and
    arguments (at most 60 characters)."""
    s = name.replace("(anonymous namespace)", "anon")
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    head = s[:cut]
    while True:  # drop template arguments, innermost first
        stripped = re.sub(r"<[^<>]*>", "", head)
        if stripped == head:
            break
        head = stripped
    parts = head.replace("::", " ").split()
    return (parts[-1] if parts else name)[:60]


def merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device and host events of one traced window."""

    def __init__(self, events: list):
        wins = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"expected one {WINDOW} annotation, found {len(wins)}")
        self.t0 = float(wins[0]["ts"])
        self.t1 = self.t0 + float(wins[0]["dur"])

        def inside(e):
            s = float(e["ts"])
            return s < self.t1 and s + float(e.get("dur", 0.0)) > self.t0

        timed = [e for e in events if "ts" in e and "dur" in e and inside(e)]
        self.device = [e for e in timed if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.copies = [e for e in self.device if e["cat"] == "gpu_memcpy"]
        self.host = [e for e in timed if e.get("cat") in HOST_CATS
                     and e.get("name") not in (WINDOW, BATCH)]
        self.runtime = [e for e in timed if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        self.batches = sum(1 for e in timed if e.get("name") == BATCH
                           and e.get("cat") == "user_annotation")

    @classmethod
    def from_file(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def _clipped(self, events):
        return [(max(float(e["ts"]), self.t0), min(float(e["ts"]) + float(e["dur"]), self.t1))
                for e in events]

    def busy_s(self) -> float:
        """Seconds of the window in which any device event ran."""
        return sum(e - s for s, e in merge(self._clipped(self.device))) / 1e6

    def kernel_seconds(self, pattern=None, exclude=None) -> tuple:
        """(seconds, count) of the kernels whose name ``pattern`` finds (all
        with None), less those ``exclude`` finds."""
        t, n = 0.0, 0
        for e in self.kernels:
            if pattern is not None and not pattern.search(e["name"]):
                continue
            if exclude is not None and exclude.search(e["name"]):
                continue
            t += float(e["dur"])
            n += 1
        return t / 1e6, n

    def copy_seconds(self, kinds=("HtoD", "DtoH")) -> tuple:
        """(seconds, count) of the memcpys between host and device."""
        sel = [e for e in self.copies if any(k in e["name"] for k in kinds)]
        return sum(float(e["dur"]) for e in sel) / 1e6, len(sel)

    def launches(self) -> int:
        """Kernel-launch API calls the host made in the window."""
        return sum(1 for e in self.runtime if _LAUNCH.match(e.get("name", "")))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds], ...]: the device operations that took most
        time, kernels by identifier, copies by direction."""
        tot = {}
        for e in self.device:
            name = short_name(e["name"]) if e["cat"] == "kernel" else e["name"]
            tot[name] = tot.get(name, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host activity, seconds], ...]: the device's idle time in the
        window, by the innermost host event running at each gap's middle
        (``host`` where none runs), largest first."""
        busy = merge(self._clipped(self.device))
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                       for e in self.host))
        starts = [h[0] for h in host]
        tot = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            name = "host"
            # the latest start that covers mid is the innermost event; a
            # gap that no recent event covers is the host's own Python
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - _LOOKBACK), -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
            tot[name] = tot.get(name, 0.0) + (e - s) / 1e6
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
