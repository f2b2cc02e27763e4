"""One run of one cell: set-up, the measured window, the check, the result.

Set-up (``setup_s``, from the first statement of ``run.py`` to the window's
start): the CUDA context, the program's kernel libraries (built by nvcc into
``ceph_tpu_torch/_build/`` at a checkout's first run, loaded after), the
cell's objects made on the host from the seed, the codec, the mix's own
set-up (a degraded read's objects encoded), one op of every shape and
signature the mix uses, and ``WARM_OPS`` ops of every caller at once.

The window: each caller sends its next op when its last one returns (a
closed loop) until ``--seconds`` have passed; the window ends when the last
op returns.  ``SAMPLE`` answers of the window's ops are kept: those of the
ops that start first after instants drawn from the seed.  Once the window has closed and the device's peak memory
has been read, the plain reference works out every kept answer again from
the objects and the check compares them byte for byte (see
``compare``).  Metrics come from the readers under ``metrics/``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ecbench import roofline, spec, tracing

#: top-level module names that no run may have loaded: the JAX stack and
#: the JAX package the port was made from (compared whole, not as prefixes)
FORBIDDEN = ("jax", "jaxlib", "flax", "ceph_tpu")
#: answers of the window that a run compares with the reference
SAMPLE = 32
#: ops each caller runs at once in set-up, after one op of every shape
WARM_OPS = 8


class NoDevice(Exception):
    """The run needs more cards than this machine has."""


class ProgramMissing(Exception):
    """The program under test cannot be imported from this checkout."""


class Forbidden(Exception):
    """A module that no run may load was loaded."""


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Run:
    """What the metric readers read."""

    family: str  # the mix's kind of op: "encode" or "decode"
    setup_s: float
    window_s: float
    latencies_ns: np.ndarray
    ops: int
    failed: int
    object_bytes: int
    kernel_bytes: int
    device_name: str
    counters: Dict[str, Dict] = field(default_factory=dict)
    host: Dict[str, float] = field(default_factory=dict)
    trace: Optional[tracing.Summary] = None

    @property
    def peak_bytes_per_s(self):
        return roofline.peak_bytes_per_s(self.device_name)


class _Caller:
    """One closed-loop caller: its ops, latencies and kept answers.

    The answers kept are those of the ops that start first after `keep`
    instants drawn from the seed over the window, so the answers held for
    the check, whose buffers the program cannot reuse, are spread evenly
    over the window."""

    def __init__(self, ops: List, keep: int, seconds: float, seed: int,
                 index: int) -> None:
        self.ops = ops
        rng = np.random.default_rng([seed, 2, index])
        self.marks = np.sort(rng.integers(0, int(seconds * 1e9), keep))
        self.lat: List[int] = []
        self.ends: List[int] = []
        self.done: List = []
        self.kept: List = []
        self.failed = 0
        self.errors: List[str] = []
        self.end = 0

    def loop(self, call: Callable, t0: int, deadline: int) -> None:
        ops, n_ops = self.ops, len(self.ops)
        lat, ends, done, kept = self.lat, self.ends, self.done, self.kept
        marks = (t0 + self.marks).tolist() + [deadline * 2]
        m = 0
        clock = time.perf_counter_ns
        n = 0
        while True:
            op = ops[n % n_ops]
            t = clock()
            keep = t >= marks[m]
            while t >= marks[m]:
                m += 1
            try:
                out = call(op)
            except Exception as e:  # an answer that never came
                out = None
                self.failed += 1
                if len(self.errors) < 3:
                    self.errors.append(f"{type(e).__name__}: {e}")
            t2 = clock()
            lat.append(t2 - t)
            ends.append(t2)
            done.append(op)
            if keep and out is not None:
                kept.append((op, out))
            n += 1
            if t2 >= deadline:
                break
        self.end = t2


def _counter_delta(before: Dict, after: Dict) -> Dict:
    out = {}
    for name, value in after.items():
        old = before.get(name)
        if isinstance(value, dict) and "avgcount" in value:
            out[name] = {"avgcount": value["avgcount"] - old["avgcount"],
                         "sum": value["sum"] - old["sum"]}
        elif isinstance(value, (int, float)):
            out[name] = value - old
    return out


def _counter_sets(readers) -> Dict[str, object]:
    """The program's counter sets that the readers name (``COUNTERS``)."""
    import importlib

    sets = {}
    for reader in readers.values():
        for module, attr in getattr(reader, "COUNTERS", ()):
            pc = getattr(importlib.import_module(module), attr)
            sets[pc.name] = pc
    return sets


def make_objects(seed: int, count: int, size: int) -> List[memoryview]:
    """`count` distinct objects of `size` seeded random bytes, as read-only
    views of one host buffer."""
    rng = np.random.Generator(np.random.PCG64(seed))
    n = count * size
    words = rng.integers(0, 2**64 - 1, size=-(-n // 8), dtype=np.uint64,
                         endpoint=True)
    blob = memoryview(words.view(np.uint8)[:n].tobytes())
    return [blob[i * size:(i + 1) * size] for i in range(count)]


def compare(answers) -> Dict[str, int]:
    """Byte-for-byte comparison of (what, got, expected) answers, each a
    dict chunk id -> bytes.  An answer is bad if its chunk ids differ from
    the expected ones or any byte of any chunk differs."""
    bad_bytes = bad_answers = compared = 0
    for _, got, want in answers:
        ok = set(got) == set(want)
        for c, e in want.items():
            g = got.get(c)
            g = None if g is None else np.asarray(g, dtype=np.uint8).ravel()
            compared += e.size
            if g is None or g.size != e.size:
                bad_bytes += e.size
                ok = False
                continue
            diff = int(np.count_nonzero(g != e))
            bad_bytes += diff
            ok = ok and diff == 0
        bad_answers += not ok
    return {"answers": len(answers), "bytes": compared,
            "bad_answers": bad_answers, "bad_bytes": bad_bytes}


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def _log(err, *parts) -> None:
    print(*parts, file=err, flush=True)


def run_cell(workload: str, seed: int, seconds: int, trace: bool, *,
             t_start: float, root: str = ".", device: str = "cuda",
             sizes: Optional[Dict] = None,
             make_codec: Optional[Callable] = None,
             err=sys.stderr) -> dict:
    """One run; returns the result line's object.  `device`, `sizes`
    (overrides of the configuration's and mix's numbers) and `make_codec`
    (config, device -> codec) are for the tests and the control, never the
    command line."""
    cell = spec.load_cell(root, workload, trace)
    config, mix = dict(cell.config), dict(cell.mix)
    for key, value in (sizes or {}).items():
        (config if key in config else mix)[key] = value
    kind = spec.load_module("kinds", mix["op"], root)
    reference = spec.load_module("references", config["reference"], root)
    readers = spec.readers(cell.metrics, root)

    try:
        from ceph_tpu_torch.ec.registry import registry
        from ceph_tpu_torch.ops import build
    except ImportError as e:
        raise ProgramMissing(f"cannot import the program: {e}") from e
    import torch
    t_imports = time.perf_counter() - t_start

    cuda = device.startswith("cuda")
    if cuda and (not torch.cuda.is_available()
                 or torch.cuda.device_count() < cell.chips):
        raise NoDevice(
            f"{workload} needs {cell.chips} CUDA device(s); "
            f"available={torch.cuda.is_available()}, count="
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")

    t = time.perf_counter()
    if cuda:
        torch.cuda.init()
        built = build.build_all()
        _log(err, "build", json.dumps({n: s for n, (s, _) in built.items()}))
    t_build = time.perf_counter() - t

    t = time.perf_counter()
    objects = make_objects(seed, int(mix["objects"]), int(config["object_size"]))
    t_objects = time.perf_counter() - t

    t = time.perf_counter()
    if make_codec is None:
        codec = registry.factory(config["plugin"], "", config["profile"],
                                 device=device)
    else:
        codec = make_codec(config, device)
    plan = kind.Plan(codec, objects, config, mix,
                     np.random.default_rng([seed, 1]))
    callers = [_Caller(ops, -(-SAMPLE // len(plan.callers)), seconds, seed, i)
               for i, ops in enumerate(plan.callers)]
    for op in plan.warm:
        plan.call(op)
    _in_threads([lambda c=c: [plan.call(op) for op in c.ops[:WARM_OPS]]
                 for c in callers])
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter() - t

    spans: Dict[str, List[Tuple[int, int]]] = {}
    call = plan.call
    if trace:
        call = _traced(plan, codec, kind.FAMILY, spans)
    sets = _counter_sets(readers)
    before = {name: pc.dump() for name, pc in sets.items()}
    profiler = tracing.Profiler() if trace and cuda else None
    if profiler:
        profiler.start()
    t0 = time.perf_counter_ns()
    deadline = t0 + int(seconds * 1e9)
    _in_threads([lambda c=c: c.loop(call, t0, deadline) for c in callers])
    if cuda:
        torch.cuda.synchronize()
    t_end = max(c.end for c in callers)
    summary = None
    if trace:  # without a card, the host's spans over the host's window
        if profiler:
            profiler.stop()
        summary = tracing.summarize(profiler.events if profiler else [],
                                    spans, t0, t_end)
    after = {name: pc.dump() for name, pc in sets.items()}
    setup_s = t0 / 1e9 - t_start
    window_s = (t_end - t0) / 1e9

    seam = spans.get(tracing.SEAM, [])
    done = [op for c in callers for op in c.done]
    lat = np.array([x for c in callers for x in c.lat], dtype=np.int64)
    failed = sum(c.failed for c in callers)
    chunk_size = plan.chunk_size
    run = Run(
        family=kind.FAMILY, setup_s=setup_s,
        window_s=window_s, latencies_ns=lat, ops=len(done), failed=failed,
        object_bytes=sum(plan.object_bytes(op) for op in done),
        kernel_bytes=sum(roofline.kernel_bytes(*plan.kernel_chunks(op),
                                               chunk_size) for op in done),
        device_name=torch.cuda.get_device_name(0) if cuda else "cpu",
        counters={n: _counter_delta(before[n], after[n]) for n in sets},
        host={"op_s": float(lat.sum()) / 1e9,
              "seam_s": sum(b - a for a, b in seam) / 1e9,
              "seam_calls": len(seam)},
        trace=summary)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    units = {m["name"]: m["unit"] for m in cell.metrics}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(run)
        if value is None:
            if not trace:
                raise spec.SpecError(f"end-to-end metric {name} read "
                                     f"nothing in {workload}")
            _log(err, f"metric {name}: nothing to read in this run")
            continue
        metrics[name] = {"value": float(value), "unit": units[name]}

    # the check: the program's state goes first, then the reference runs
    kept = [pair for c in callers for pair in c.kept]
    del codec, call
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference.Code(config["profile"])
    answers = [(f"op {op}", out, plan.expected(ref, op)) for op, out in kept]
    answers += plan.setup_answers(ref, [op for op, _ in kept])
    verdict = compare(answers)
    t_check = time.perf_counter() - t

    found = forbidden_modules()
    if found:
        raise Forbidden(f"loaded modules no run may load: {found}")

    checks = {"bad_bytes": (verdict["bad_bytes"], 0),
              "bad_answers": (verdict["bad_answers"], 0),
              "failed_ops": (failed, 0)}
    correct = verdict["answers"] > 0 and all(
        v <= limit for v, limit in checks.values())
    power = _power_limit() if cuda else None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": run.device_name, "count": cell.chips if cuda else 0,
           "memory_peak_bytes": int(peak)}
    if power:
        dev["power_limit"] = power
    result = {"correct": correct, "attempted": run.ops, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        s = run.trace
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in s.device_ops],
                               "idle_gaps": [list(x) for x in s.idle_gaps]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in checks.items()}

    _log(err, f"cell {workload} seed {seed} on {run.device_name}"
         f" (power limit {power}), trace {int(trace)}")
    _log(err, "setup_s", json.dumps({
        "total": setup_s, "imports": t_imports, "build": t_build,
        "objects": t_objects, "codec_and_warm": t_warm}))
    p50, p99 = (np.percentile(lat, [50, 99]) / 1e6).tolist() if lat.size \
        else (math.nan, math.nan)
    _log(err, f"ops {run.ops} in {window_s} s by {len(callers)} caller(s): "
         f"p50 {p50} ms, p99 {p99} ms over {lat.size} samples; "
         f"{failed} failed {[e for c in callers for e in c.errors]}")
    ends = np.array([x for c in callers for x in c.ends], dtype=np.int64)
    per_s = np.bincount((ends - t0) // 1_000_000_000).tolist() if ends.size \
        else []
    _log(err, f"ops completed in each second of the window: {per_s}")
    if summary is not None:
        _log(err, f"trace: {summary.device_events} device events, "
             f"{summary.markers} markers, window {summary.window_s} s")
    for name, m in metrics.items():
        _log(err, f"metric {name} {m['value']} {m['unit']}")
    _log(err, f"check: {verdict['answers']} answers, {verdict['bytes']} bytes "
         f"compared with the reference in {t_check} s")
    for name, (v, lim) in checks.items():
        _log(err, f"check {name} {v} limit {lim}")
    return result


def _traced(plan, codec, family: str,
            spans: Dict[str, List[Tuple[int, int]]]) -> Callable:
    """plan.call and the codec's seams inside the benchmark's host spans:
    (start, end) on the perf_counter_ns clock, by span name."""
    seam = spans.setdefault(tracing.SEAM, [])
    for name in ("_apply", "_apply_rows"):
        inner = getattr(codec, name, None)
        if inner is None:
            continue

        def timed(*args, _inner=inner, **kwargs):
            t = time.perf_counter_ns()
            try:
                return _inner(*args, **kwargs)
            finally:
                seam.append((t, time.perf_counter_ns()))

        setattr(codec, name, timed)
    ops = spans.setdefault(f"ecbench.{family}", [])

    def call(op):
        t = time.perf_counter_ns()
        try:
            return plan.call(op)
        finally:
            ops.append((t, time.perf_counter_ns()))

    return call


def _in_threads(jobs: List[Callable]) -> None:
    """Run the jobs at once, one thread each (the calling thread for one),
    and wait for every one; the first error is raised."""
    if len(jobs) == 1:
        jobs[0]()
        return
    errors: List[BaseException] = []
    start = threading.Barrier(len(jobs))

    def body(job):
        try:
            start.wait()
            job()
        except BaseException as e:  # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=body, args=(j,)) for j in jobs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
