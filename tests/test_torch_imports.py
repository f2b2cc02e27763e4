"""ceph_tpu_torch stands alone: it imports neither jax nor any ceph_tpu
module, and its entry points resolve to the CUDA device unless told "cpu"."""

import ast
import os
import re
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
import ceph_tpu_torch.mgr.daemon
import ceph_tpu_torch.mgr.modules
import ceph_tpu_torch.native.bridge
import ceph_tpu_torch.ops.cuda_gf2
import ceph_tpu_torch.ops.cuda_packedbit
import ceph_tpu_torch.ops.slab
import ceph_tpu_torch.parallel.mesh
import ceph_tpu_torch.parallel.service
import ceph_tpu_torch.rados.bluestore
import ceph_tpu_torch.rados.client
import ceph_tpu_torch.rados.ecutil
import ceph_tpu_torch.rados.librados
import ceph_tpu_torch.rados.messenger
import ceph_tpu_torch.rados.mon
import ceph_tpu_torch.rados.neorados
import ceph_tpu_torch.rados.osd
import ceph_tpu_torch.rados.pagestore
import ceph_tpu_torch.rados.reactor_proc
import ceph_tpu_torch.rados.striper
import ceph_tpu_torch.rados.unpickle
import ceph_tpu_torch.rados.vstart
import ceph_tpu_torch.services.cls
import ceph_tpu_torch.services.mds
import ceph_tpu_torch.services.mds_cluster
import ceph_tpu_torch.services.rbd
import ceph_tpu_torch.services.rbd_export
import ceph_tpu_torch.services.rgw
import ceph_tpu_torch.tools.bench_suite
import ceph_tpu_torch.tools.benchmark
import ceph_tpu_torch.tools.ceph
import ceph_tpu_torch.tools.ceph_volume
import ceph_tpu_torch.tools.cephadm
import ceph_tpu_torch.tools.cephfs_shell
import ceph_tpu_torch.tools.dencoder
import ceph_tpu_torch.tools.lint.__main__
import ceph_tpu_torch.tools.lint.async_safety
import ceph_tpu_torch.tools.lint.codec
import ceph_tpu_torch.tools.lint.registry
import ceph_tpu_torch.tools.lint.wire_abi
import ceph_tpu_torch.tools.monstore_tool
import ceph_tpu_torch.tools.non_regression
import ceph_tpu_torch.tools.objectstore_tool
import ceph_tpu_torch.tools.radosgw_admin
import ceph_tpu_torch.tools.rados
import ceph_tpu_torch.tools.rbd
import ceph_tpu_torch.tools.trace_export
import ceph_tpu_torch.tools.traffic
import ceph_tpu_torch.tools.wire_corpus
import ceph_tpu_torch.utils.checksum
import ceph_tpu_torch.utils.wirepath
ceph_tpu_torch.utils.wirepath.kind()  # builds and probes the native arm
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


FORBIDDEN_TOPS = ("jax", "ceph_tpu")


def forbidden_imports(source):
    """Every module of jax or ceph_tpu (not ceph_tpu_torch) that `source`
    imports: each name of an ``import`` list and each ``from`` module, at
    any depth of nesting (the probe above sees only what one run imports,
    and a function-level import runs only when its function is called), and
    each constant name given to ``import_module`` or ``__import__``."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")):
            names.append(node.args[0].value)
    return [n for n in names if n.split(".")[0] in FORBIDDEN_TOPS]


def port_sources():
    """The port's package and chip_smoke.py, which is held to the same
    rule."""
    top = os.path.join(ROOT, "ceph_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if not d.startswith(("_", "."))]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_port_source_imports_jax_or_ceph_tpu():
    sources = list(port_sources())
    for sentinel in (("mgr", "daemon.py"), ("services", "rgw.py"),
                     ("services", "mds.py"), ("services", "mds_cluster.py"),
                     ("tools", "radosgw_admin.py"),
                     ("tools", "cephfs_shell.py"),
                     ("tools", "non_regression.py"), ("tools", "cephadm.py"),
                     ("tools", "lint", "__init__.py")):
        assert any(p.endswith(os.path.join(*sentinel)) for p in sources)
    assert os.path.isfile(sources[-1])
    bad = {}
    for path in sources:
        with open(path) as f:
            hits = forbidden_imports(f.read())
        if hits:
            bad[os.path.relpath(path, ROOT)] = hits
    assert bad == {}


@pytest.mark.parametrize("line,forbidden", [
    ("from ceph_tpu.rados.types import MOSDOp", True),
    ("        from ceph_tpu.rados import unpickle", True),
    ("    import ceph_tpu.rados.osd as ref", True),
    ("import jax", True),
    ("    from jax import numpy as jnp", True),
    ("import jax.numpy as jnp", True),
    ("from ceph_tpu import rados", True),
    ("import os, jax", True),
    ("import numpy as np, ceph_tpu.rados", True),
    ('importlib.import_module("ceph_tpu.rados.osd")', True),
    ('__import__("jax")', True),
    ("from ceph_tpu_torch.rados.types import MOSDOp", False),
    ("    import ceph_tpu_torch.rados.osd", False),
    ("import jaxtyping", False),
    ("from . import jax", False),
    ('importlib.import_module(f"ceph_tpu_torch.ec.plugins.{name}")', False),
    ('MAGIC = b"ceph_tpu-rbd-diff-v1"', False),
    ("# the reference imports ceph_tpu.rados here", False),
])
def test_import_scan_pattern(line, forbidden):
    assert bool(forbidden_imports(line.strip() + "\n")) == forbidden


def test_import_scan_sees_function_level_imports():
    source = ("def f():\n"
              "    if True:\n"
              "        from ceph_tpu.rados.types import MOSDOp\n"
              "    import os, jax.numpy\n")
    assert sorted(forbidden_imports(source)) == ["ceph_tpu.rados.types",
                                                 "jax.numpy"]


# a dotted module path of the reference in a string: an argv "-m" target, an
# import_module argument, a __module__ prefix
REFERENCE_MODULE = re.compile(r"(?<![\w./])ceph_tpu\.(?=[A-Za-z_]|$)")
# the one place the port names the reference's modules on purpose: the
# unpickler's mapping of their class paths onto its own
REFERENCE_MODULE_ALLOWED = (os.path.join("ceph_tpu_torch", "rados",
                                         "unpickle.py"),)


def reference_module_strings(source):
    """Every string constant of `source`, docstrings aside, that names a
    module of the reference package (``ceph_tpu.<...>``, not
    ``ceph_tpu_torch``): the import scan above cannot see a module a
    program names in a string and imports or runs later."""
    tree = ast.parse(source)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docstrings.add(id(body[0].value))
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docstrings
            and REFERENCE_MODULE.search(node.value)]


def test_no_port_source_names_a_reference_module_in_a_string():
    bad = {}
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel in REFERENCE_MODULE_ALLOWED:
            continue
        with open(path) as f:
            hits = reference_module_strings(f.read())
        if hits:
            bad[rel] = hits
    assert bad == {}


@pytest.mark.parametrize("line,named", [
    ('cmd = [sys.executable, "-m", "ceph_tpu.rados.vstart"]', True),
    ('importlib.import_module("ceph_tpu.tools.non_regression")', True),
    ('ok = cls.__module__.startswith("ceph_tpu.")', True),
    ('log = logging.getLogger("ceph_tpu.checksum")', True),
    ('msg = f"run python -m ceph_tpu.tools.lint --update-wire-lock"', True),
    ('cmd = [sys.executable, "-m", "ceph_tpu_torch.rados.vstart"]', False),
    ('ok = cls.__module__.startswith("ceph_tpu_torch.")', False),
    ('REPLACES = "ceph_tpu/ops/pallas_gf2.py:57"', False),
    ('MAGIC = b"ceph_tpu-rbd-diff-v1"', False),
    ('_REFERENCE = "ceph_tpu"', False),
    ('def f():\n    """Copy of ceph_tpu.rados.osd."""\n', False),
])
def test_reference_module_string_pattern(line, named):
    assert bool(reference_module_strings(line + "\n")) == named


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


def test_gateway_and_cephfs_modules_do_not_import_torch():
    """rgw, the MDS and their CLIs are clients of RADOS: their device work
    is the OSDs', so importing them brings in no torch."""
    probe = ("import sys\n"
             "import ceph_tpu_torch.services.rgw\n"
             "import ceph_tpu_torch.services.mds_cluster\n"
             "import ceph_tpu_torch.tools.radosgw_admin\n"
             "import ceph_tpu_torch.tools.cephfs_shell\n"
             "print(','.join(sorted(m for m in sys.modules\n"
             "    if m == 'torch' or m.startswith('torch.'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_tool_modules_import_torch_only_when_they_run_a_codec():
    """The offline and operator tools import torch only inside the calls
    that build a codec or start a cluster (non_regression, bench_suite):
    importing any of them, the lint included, brings in no torch."""
    probe = ("import sys\n"
             "for name in ('bench_suite', 'ceph', 'ceph_volume', 'cephadm',\n"
             "             'dencoder', 'lint.__main__', 'monstore_tool',\n"
             "             'non_regression', 'objectstore_tool',\n"
             "             'trace_export', 'traffic', 'wire_corpus'):\n"
             "    __import__('ceph_tpu_torch.tools.' + name)\n"
             "print(','.join(sorted(m for m in sys.modules\n"
             "    if m == 'torch' or m.startswith('torch.'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
