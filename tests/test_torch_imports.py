"""ceph_tpu_torch stands alone: it imports neither jax nor any ceph_tpu
module, and its entry points resolve to the CUDA device unless told "cpu"."""

import os
import subprocess
import sys

import pytest
import torch

from ceph_tpu_torch.utils.cudadev import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import sys
import ceph_tpu_torch.common.context
import ceph_tpu_torch.ec.plugins.clay
import ceph_tpu_torch.ec.plugins.cuda
import ceph_tpu_torch.ec.plugins.isa
import ceph_tpu_torch.ec.plugins.lrc
import ceph_tpu_torch.ec.plugins.shec
import ceph_tpu_torch.ec.plugins.xor
import ceph_tpu_torch.native.bridge
import ceph_tpu_torch.ops.cuda_gf2
import ceph_tpu_torch.ops.cuda_packedbit
import ceph_tpu_torch.ops.slab
import ceph_tpu_torch.parallel.service
import ceph_tpu_torch.rados.bluestore
import ceph_tpu_torch.rados.client
import ceph_tpu_torch.rados.ecutil
import ceph_tpu_torch.rados.messenger
import ceph_tpu_torch.rados.mon
import ceph_tpu_torch.rados.osd
import ceph_tpu_torch.rados.pagestore
import ceph_tpu_torch.rados.reactor_proc
import ceph_tpu_torch.rados.unpickle
import ceph_tpu_torch.rados.vstart
import ceph_tpu_torch.services.cls
import ceph_tpu_torch.tools.benchmark
import ceph_tpu_torch.utils.checksum
import ceph_tpu_torch.utils.wirepath
from ceph_tpu_torch.ec.registry import registry
registry.factory("jerasure", "", {"plugin": "jerasure", "k": "2", "m": "1"})
for plugin in ("isa", "shec", "clay", "xor"):
    registry.factory(plugin, "", {"plugin": plugin}).encode({0, 1}, b"x" * 64)
registry.factory("lrc", "", {"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "ceph_tpu" or m.startswith("ceph_tpu."))
print(",".join(bad))
"""


def test_port_imports_neither_jax_nor_ceph_tpu():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", f"port pulled in: {out.stdout.strip()}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for asked in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(asked)


def test_resolve_device_cpu_only_when_named():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_reactor_worker_module_does_not_import_torch():
    """Under ms_reactor_mode=process the messenger forks reactor workers
    from a daemon that may have touched CUDA; a forked child must never
    touch CUDA, so the worker's module must not bring in torch (nor the
    queue or the resident store)."""
    probe = ("import sys\n"
             "import ceph_tpu_torch.rados.reactor_proc\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'torch'\n"
             "    or m.endswith(('parallel.service', 'rados.pagestore')))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
