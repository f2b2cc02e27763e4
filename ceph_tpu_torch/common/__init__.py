"""Foundation/runtime layer (reference src/common/, src/log/, src/global/).

Copy of ceph_tpu/common/__init__.py at commit 4ac5bd2: everything above this
layer — messenger, mon, OSD, EC plugins, tools — consumes these services
through a `CephContext`-equivalent bundle
(:class:`ceph_tpu_torch.common.context.Context`): typed config with change
observers, perf counters, leveled per-subsystem logging with an in-memory
crash ring, an admin-socket command server, and throttles.
"""

from ceph_tpu_torch.common.config import Config, Option, OPT_BOOL, OPT_FLOAT, OPT_INT, OPT_SECS, OPT_SIZE, OPT_STR
from ceph_tpu_torch.common.context import Context
from ceph_tpu_torch.common.perf_counters import PerfCounters, PerfCountersBuilder, PerfCountersCollection
from ceph_tpu_torch.common.throttle import Throttle

__all__ = [
    "Config",
    "Context",
    "Option",
    "OPT_BOOL",
    "OPT_FLOAT",
    "OPT_INT",
    "OPT_SECS",
    "OPT_SIZE",
    "OPT_STR",
    "PerfCounters",
    "PerfCountersBuilder",
    "PerfCountersCollection",
    "Throttle",
]
