"""The program's own trace of the window: its process tracer's spans and its
seam-step counters, for the readers under ``metrics/`` that name them.

The harness dumps every counter set a reader names in ``COUNTERS`` right
before the window and right after it.  ``WINDOW`` is such a set for the
program's process tracer (``ceph_tpu_torch.common.tracing``, ``PROCESS``):
its dump before the window turns the tracer on, its dump after turns it off
and keeps what it recorded as ``WINDOW.spans``, span name -> [(start_ns,
end_ns)] on ``time.time_ns()``.  Its numbers are the spans kept and
dropped.  Only the per-layer readers name it, so only a traced run turns
the tracer on.  A program without the process tracer gives neither numbers
nor spans, and its readers return None.

``WINDOW`` has to be dumped in turns, one dump opening and the next closing
the window, and only in traced runs; a dump that finds the tracer in the
other state (already on where it would open, off where it would close)
raises.  ``test_ecbench_program_trace.py`` holds the end-to-end readers to
never naming ``SET``, so the tracer never runs in a timed, untraced window.

After the window it writes to standard error the spans kept and dropped,
the placement check and the stalls.  The placement check: a
``tracing.Profiler`` session with ``MARKS`` marker kernels in it, each
launched on an idle card right after a ``time.time_ns()`` read, and the
median of each marker's start on the trace (the profiler's own ns stamp,
``ts`` * 1000 + ``baseTimeNanoseconds`` of its chrome trace) less that
read, paired from the last marker.  The program's spans lie on the device
trace by their own clock if it is 0 to 1 ms.  The stalls: the seconds of
the window, from its first op, that completed under half the median ops,
with the codec call's ms an op in them and the spans below it whose ms an
op grew most.
"""

from __future__ import annotations

import importlib
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

from ecbench import tracing

#: what a reader names in COUNTERS to have the program's spans
SET = ("ecbench.program_trace", "WINDOW")
#: markers of the placement check
MARKS = 8


def _process_tracer():
    try:
        tracing = importlib.import_module("ceph_tpu_torch.common.tracing")
    except ImportError:
        return None
    return getattr(tracing, "PROCESS", None)


class _Window:
    """The process tracer over the window, as a counter set."""

    name = "program_trace"

    def __init__(self) -> None:
        self.spans: Dict[str, List[Tuple[int, int]]] = {}
        self._open = False

    def dump(self) -> dict:
        tracer = _process_tracer()
        if tracer is None:
            self.spans = {}
            return {}
        if not self._open:
            if tracer.enabled:
                raise RuntimeError(
                    "program_trace.WINDOW opens with the process tracer "
                    "already on: dumped out of turn, or enabled elsewhere")
            self.spans = {}
            self._open = True
            tracer.enable()
            return {"spans": 0, "dropped": 0}
        if not tracer.enabled:
            raise RuntimeError(
                "program_trace.WINDOW closes with the process tracer off: "
                "dumped out of turn, or disabled elsewhere")
        tracer.disable()
        self._open = False
        records, dropped = tracer.drain()
        spans: Dict[str, List[Tuple[int, int]]] = {}
        for name, start, end, *_ in records:
            spans.setdefault(name, []).append((start, end))
        self.spans = spans
        _log(f"program spans: {len(records)} kept, {dropped} dropped")
        _log(f"placement check: {placement_check()}")
        _log(f"stalls: {stalls(spans)}")
        return {"spans": len(records), "dropped": dropped}


WINDOW = _Window()


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def placement_check() -> str:
    """Where the device trace's clock lies against time.time_ns(), as a
    line for standard error."""
    try:
        import torch

        if not torch.cuda.is_initialized():
            return "no CUDA in this run"
        offsets = _marker_offsets(torch)
    except Exception as e:  # the check informs; it never fails a run
        return f"failed: {type(e).__name__}: {e}"
    if not offsets:
        return "no markers on the trace"
    med = statistics.median(offsets) / 1e3
    where = "on" if 0 <= med <= 1000 else "NOT on"
    return (f"marker start less host read, median {med} us (min "
            f"{min(offsets) / 1e3}, max {max(offsets) / 1e3}, "
            f"{len(offsets)} of {MARKS} markers): device trace {where} "
            "time.time_ns()")


def _marker_offsets(torch) -> List[int]:
    prof = tracing.Profiler()
    host = []
    prof.start()
    for _ in range(MARKS):
        torch.cuda.synchronize()
        host.append(time.time_ns())
        torch.cuda._sleep(1000)
    prof.stop()
    # the session's own ns stamps (its chrome trace's ts * 1000 +
    # baseTimeNanoseconds); the last marker is stop()'s, and the records
    # lost at a session's start are the first markers': pair from the last
    starts = sorted(e.start_ns() for e in
                    prof._prof.profiler.kineto_results.events()
                    if tracing.MARKER in e.name())[:-1]
    return [s - h for s, h in zip(starts[::-1], host[::-1])]


def stalls(spans: Dict[str, List[Tuple[int, int]]], top: int = 3) -> str:
    """The seconds of the window that completed under half the median ops,
    the codec call's ms an op in them and in the others, and the `top`
    spans below it whose ms an op grew most, as a line."""
    root = next((n for n in ("ec.encode", "ec.decode") if spans.get(n)), "")
    if not root:
        return "no codec calls"
    roots = spans[root]
    t0 = min(a for a, _ in roots)
    ops = [0] * ((max(b for _, b in roots) - t0) // 1_000_000_000 + 1)
    for _, b in roots:
        ops[(b - t0) // 1_000_000_000] += 1
    full = ops[:-1] or ops  # the last second is cut short by the window
    med = statistics.median(full)
    slow = {s for s, n in enumerate(full) if n < med / 2}
    if not slow:
        return (f"none: every second completed at least half the median "
                f"{med} ops ({min(full)} to {max(full)})")
    in_slow = sum(ops[s] for s in slow) or 1
    in_rest = sum(n for s, n in enumerate(full) if s not in slow) or 1
    grown = []
    for name, pairs in spans.items():
        ms = [0.0, 0.0]
        for a, b in pairs:
            s = (a - t0) // 1_000_000_000
            if s < len(full):
                ms[s not in slow] += (b - a) / 1e6
        grown.append((ms[0] / in_slow - ms[1] / in_rest, name,
                      ms[0] / in_slow, ms[1] / in_rest))
    grown.sort(reverse=True)
    whole = next(g for g in grown if g[1] == root)
    below = [g for g in grown if g[1] != root][:top]
    return (f"seconds {sorted(slow)} of {len(full)} under half the median "
            f"{med} {root} ops; ms an op there against the other seconds: "
            f"{root} {whole[2]} against {whole[3]}; below it "
            + ", ".join(f"{n} {a} against {b}" for _, n, a, b in below))


def ms_an_op(run, family: str, *names: str) -> Optional[float]:
    """Summed time of the program's spans `names` over the window's codec
    calls of `family` ("encode" or "decode"), ms a call."""
    calls = len(WINDOW.spans.get(f"ec.{family}", ()))
    if run.family != family or calls == 0:
        return None
    ns = sum(b - a for n in names for a, b in WINDOW.spans.get(n, ()))
    return ns / calls / 1e6


def step_ms(run, family: str, step: str) -> Optional[float]:
    """ms a seam dispatch spends in one step (``h2d``, ``d2h``), from the
    program's ec_plugin ``<step>_s`` average."""
    c = run.counters.get("ec_plugin") or {}
    avg = c.get(f"{step}_s")
    if run.family != family or not avg or avg["avgcount"] == 0:
        return None
    return avg["sum"] / avg["avgcount"] * 1e3
