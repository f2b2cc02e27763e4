"""The traced run: torch.profiler over the window, read back from its trace.

The profiler records CUDA activity alone: recording the host's torch ops
as well slows a 4 MiB encode by about 15 %, and the benchmark's own host
spans say what the host was doing.  Those are taken from this folder, in
traced runs only: (start, end) on the host's perf_counter clock around each
call into the codec and each call into its seam, from every caller's
thread.  A tiny marker kernel (``torch.cuda._sleep``), waited for, opens
and closes the window on the device and puts the two clocks side by side:
the window opens on the host when the first marker has ended on the device
(where one marker is lost, the host's window length places the other).
After the window the profiler's chrome trace is written to a temporary
file, read and deleted; what the readers get is a ``Summary``: the window's
length, the device's busy time (the union of kernels, copies and memsets),
kernel and copy time by direction, the device operations that took most
time, and the idle time on the device named by the innermost host span
open at the middle of each gap (``ecbench.window`` where no op was open:
the harness between ops).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW = "ecbench.window"
SEAM = "ecbench.seam"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


@dataclass
class Summary:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernel_s: float = 0.0
    h2d_s: float = 0.0
    d2h_s: float = 0.0
    markers: int = 0
    device_events: int = 0
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


#: the marker kernel's name, as the trace has it
MARKER = "spin_kernel"
#: seconds the profiler runs before the first marker
SETTLE_S = 0.2


class Profiler:
    """torch.profiler over CUDA activity, between two marker kernels."""

    def __init__(self) -> None:
        import torch

        self._torch = torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.events: List[dict] = []

    def _mark(self) -> None:
        self._torch.cuda.synchronize()
        self._torch.cuda._sleep(1000)
        self._torch.cuda.synchronize()

    def start(self) -> None:
        self._prof.__enter__()
        # the activity records of the first few ms after the start can be
        # lost (the first copy of a window was seen 5-6 ms in): settle
        # before the first marker
        time.sleep(SETTLE_S)
        self._mark()

    def stop(self) -> None:
        self._mark()
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="ecbench-trace-", suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Cover:
    """Whether some span of one name covers an instant."""

    def __init__(self, spans: List[Tuple[float, float]]) -> None:
        spans = sorted(spans)
        self.starts = [a for a, _ in spans]
        self.reach, far = [], float("-inf")
        for _, b in spans:
            far = max(far, b)
            self.reach.append(far)

    def covers(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.reach[i] >= t


def summarize(events: List[dict], host: Dict[str, List[Tuple[int, int]]],
              t0_ns: int, t1_ns: int) -> Summary:
    """A Summary of a chrome trace's events (times in microseconds), with
    the host spans `host` (perf_counter_ns) laid on the trace's clock: the
    window runs from the end of the first marker kernel, which the host saw
    at `t0_ns`, to the start of the last, which it launched after `t1_ns`.
    With one marker the host's window length places the other end; without
    markers (no card) the window is the host's, `t0_ns` to `t1_ns`."""
    device: List[Tuple[float, float, str, str]] = []
    marks: List[Tuple[float, float]] = []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "kernel" and MARKER in name:
            marks.append((a, b))
        elif cat in DEVICE_CATS:
            device.append((a, b, cat, name))
    s = Summary(markers=len(marks), device_events=len(device))
    marks.sort()
    length = (t1_ns - t0_ns) / 1e3
    if len(marks) >= 2:
        w0, w1 = marks[0][1], marks[-1][0]
    elif marks and device and min(d[0] for d in device) >= marks[0][1]:
        # the first marker: the window's copies and kernels come after it
        w0 = marks[0][1]
        w1 = w0 + length
    elif marks:  # the last marker
        w1 = marks[0][0]
        w0 = w1 - length
    else:
        w0, w1 = t0_ns / 1e3, t1_ns / 1e3
    offset = w0 - t0_ns / 1e3
    spans = {name: [(a / 1e3 + offset, b / 1e3 + offset) for a, b in pairs]
             for name, pairs in host.items()}
    s.window_s = (w1 - w0) * 1e-6
    inside = [(max(a, w0), min(b, w1), cat, name)
              for a, b, cat, name in device if b > w0 and a < w1]
    by_name: Dict[str, float] = {}
    for a, b, cat, name in inside:
        d = (b - a) * 1e-6
        by_name[name] = by_name.get(name, 0.0) + d
        if cat == "kernel":
            s.kernel_s += d
        elif cat == "gpu_memcpy" and "HtoD" in name:
            s.h2d_s += d
        elif cat == "gpu_memcpy" and "DtoH" in name:
            s.d2h_s += d
    s.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    busy = _merge([(a, b) for a, b, _, _ in inside])
    s.busy_s = sum(b - a for a, b in busy) * 1e-6
    # innermost first: the seam, then the other ecbench spans, the window
    names = [SEAM] + sorted(n for n in spans if n != SEAM)
    covers = [(n, _Cover(spans[n])) for n in names if spans.get(n)]
    idle: Dict[str, float] = {}
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            mid = (edge + a) / 2
            name = next((n for n, c in covers if c.covers(mid)), WINDOW)
            idle[name] = idle.get(name, 0.0) + (a - edge) * 1e-6
        edge = max(edge, b)
    s.idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return s
