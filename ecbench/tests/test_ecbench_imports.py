"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the program either.  Checked in fresh interpreters."""

import json
import subprocess
import sys

from ecbench.harness import FORBIDDEN, forbidden_modules
from ecbench.tests.helpers import CELLS, ROOT


def _top_level_after(code: str) -> set:
    probe = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_and_a_cpu_run_load_no_jax():
    code = (
        "import io, time, glob, os\n"
        "from ecbench import harness, run, spec, control, tracing, readers\n"
        "for f in glob.glob('ecbench/metrics/*.py'):\n"
        "    spec.load_module('metrics', os.path.basename(f)[:-3])\n"
        "for f in glob.glob('ecbench/kinds/*.py'):\n"
        "    spec.load_module('kinds', os.path.basename(f)[:-3])\n"
        f"harness.run_cell({CELLS[0]!r}, 3, 0.2, True, "
        "t_start=time.perf_counter(), device='cpu', "
        "sizes={'object_size': 65536, 'objects': 4}, err=io.StringIO())\n")
    loaded = _top_level_after(code)
    assert "ceph_tpu_torch" in loaded  # the program was run
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_after(
        "from ecbench import spec\n"
        "spec.load_module('references', 'jerasure')\n")
    assert not loaded & (set(FORBIDDEN) | {"ceph_tpu_torch", "torch"})


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "ceph_tpu_torch_like", sys)
    assert "ceph_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "ceph_tpu.ops", sys)
    assert forbidden_modules() == ["ceph_tpu"]


def _imports(path: str) -> list:
    import ast

    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
    return [n.split(".")[0] for n in names]


def test_no_source_imports_jax_or_reads_the_jax_benchmark():
    import glob
    import os

    sources = glob.glob(os.path.join(ROOT, "ecbench", "**", "*.py"),
                        recursive=True)
    assert sources
    for path in sources:
        assert not set(_imports(path)) & set(FORBIDDEN), path
        if os.sep + "tests" + os.sep not in path:  # what a run executes
            text = open(path).read()
            assert "bench.py" not in text and "BENCH_" not in text, path
    for path in glob.glob(os.path.join(ROOT, "ecbench", "references",
                                       "*.py")):
        assert set(_imports(path)) <= {"__future__", "typing", "numpy"}, path
