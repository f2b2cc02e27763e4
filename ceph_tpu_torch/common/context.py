# Copy of ceph_tpu/common/context.py at commit 4ac5bd2, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Per-daemon service bundle (CephContext role).

Role-equivalent of the reference's CephContext (reference
src/common/ceph_context.cc): one object owning the config proxy, perf
counter collection, log, admin socket, and op tracker, created by
``global_init()``-equivalent daemon setup and threaded through every
subsystem.  Daemons that predate this layer pass plain dicts as conf; the
Context accepts those and wraps them.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

from ceph_tpu_torch.common.admin_socket import AdminSocket
from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.common.log import Log
from ceph_tpu_torch.common.perf_counters import PerfCountersCollection
from ceph_tpu_torch.common.tracing import Tracer
from ceph_tpu_torch.common.tracked_op import OpTracker

VERSION = "1.0.0-tpu"


class Context:
    def __init__(self, name: str = "client",
                 conf: Optional[Union[Config, Dict[str, Any]]] = None,
                 log_sink=None):
        if isinstance(conf, Config):
            self.conf = conf
        else:
            self.conf = Config(conf or {})
        self.name = name
        self.version = VERSION
        self.perf = PerfCountersCollection()
        self.log = Log(self.conf, sink=log_sink, name=name)
        self.asok = AdminSocket(self)
        # op tracker sized/thresholded by config (reference
        # osd_op_complaint_time / osd_op_history_size); its `optracker`
        # perf set joins the daemon collection so per-phase latencies
        # ride `perf dump` and the mgr exporter
        self.op_tracker = OpTracker(
            history_size=int(self.conf.get("osd_op_history_size", 64) or 64),
            history_slow_size=int(
                self.conf.get("osd_op_history_slow_size", 64) or 64),
            slow_threshold=float(
                self.conf.get("osd_op_complaint_time", 2.0) or 2.0),
            max_events=int(
                self.conf.get("osd_op_tracker_max_events", 128) or 128))
        self.perf.add(self.op_tracker.perf)
        self.op_tracker.register_asok(self.asok)
        self.tracer = Tracer(service=name)
        self.tracer.register_asok(self.asok)
        # runtime debug levels: the Log caches per-subsystem levels (one
        # dict lookup per dout); any debug_* change — asok `config set`,
        # `ceph tell ... config set`, a mon-pushed layer — invalidates it
        self.conf.add_observer(self._on_debug_change,
                               ("debug_*", "log_max_recent"))

    def _on_debug_change(self, conf, changed) -> None:
        self.log.invalidate_levels()

    def dout(self, subsys: str, level: int, message: str) -> None:
        self.log.dout(subsys, level, message)

    def mark_started(self) -> None:
        """global_init complete: startup options freeze, async log starts."""
        self.conf.mark_started()
        self.log.start()

    async def shutdown(self) -> None:
        await self.asok.stop()
        self.log.stop()


def global_init(name: str, conf: Optional[Dict[str, Any]] = None,
                preload_plugins: bool = True) -> Context:
    """Daemon bring-up (reference src/global/global_init.cc): build the
    context, preload EC plugins per osd_erasure_code_plugins
    (global_init_preload_erasure_code, global_init.cc:586), freeze startup
    options."""
    ctx = Context(name, conf)
    if preload_plugins:
        from ceph_tpu_torch.ec.registry import registry

        plugins = str(ctx.conf.get("osd_erasure_code_plugins", ""))
        directory = str(ctx.conf.get("erasure_code_dir", ""))
        registry.preload(",".join(plugins.replace(",", " ").split()), directory)
    ctx.mark_started()
    return ctx
