"""What the metric readers under ``metrics/`` share.

Each reader is ``metrics/<name>.py`` with ``read(run) -> float | None``
(``run`` is a ``harness.Run``) and, where it reads the program's counters,
``COUNTERS``: the (module, attribute) of each counter set it reads, which
the harness dumps before and after the window.  A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""

from __future__ import annotations

import numpy as np

#: the seam's counters (ec/plugins/cuda.py): apply / apply_rows dispatches
#: and their seconds, host to device and back included
PLUGIN = ("ceph_tpu_torch.ec.plugins.cuda", "PLUGIN_PERF")
#: the schedule LRU's counters (ops/gf2.py): hit, miss, compile
SCHED = ("ceph_tpu_torch.ops.gf2", "SCHED_PERF")


def object_GBps(run, family: str):
    """Object bytes of the window's ops over the whole window, in GB/s."""
    if run.family != family or run.ops == 0:
        return None
    return run.object_bytes / run.window_s / 1e9


def percentile_ms(run, q: float):
    if run.latencies_ns.size == 0:
        return None
    return float(np.percentile(run.latencies_ns, q)) / 1e6


def codec_host_ms(run, family: str):
    """Host time a op in the codec outside its seam: the benchmark's span
    around each call into the codec less its spans around the seam."""
    if run.family != family or not run.host.get("seam_calls"):
        return None
    return (run.host["op_s"] - run.host["seam_s"]) / run.ops * 1e3


def seam_ms(run, family: str):
    """ms a seam dispatch, from the ec_plugin counters' time averages."""
    c = run.counters.get("ec_plugin")
    if run.family != family or not c:
        return None
    n = c["apply_s"]["avgcount"] + c["apply_rows_s"]["avgcount"]
    if n == 0:
        return None
    return (c["apply_s"]["sum"] + c["apply_rows_s"]["sum"]) / n * 1e3


def copy_ms(run, family: str):
    """Device time of host-to-device and device-to-host copies, ms an op."""
    t = run.trace
    if run.family != family or t is None or t.h2d_s + t.d2h_s == 0:
        return None
    return (t.h2d_s + t.d2h_s) / run.ops * 1e3


def kernel_roofline(run, family: str):
    """The bytes the window's ops need (each input chunk read once, each
    output chunk written once) at the card's published bandwidth, as a
    share of all kernel time in the trace, in %."""
    t, peak = run.trace, run.peak_bytes_per_s
    if run.family != family or t is None or t.kernel_s == 0 or not peak:
        return None
    return run.kernel_bytes / peak / t.kernel_s * 100


def device_idle(run, family: str):
    """Share of the traced window with no kernel, copy or memset on the
    card, in %."""
    t = run.trace
    if run.family != family or t is None or t.window_s == 0 or t.busy_s == 0:
        return None
    return (1 - t.busy_s / t.window_s) * 100
