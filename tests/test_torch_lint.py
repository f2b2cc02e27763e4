"""The port's lint (ceph_tpu_torch.tools.lint) against ceph_tpu's.

The port's tree must lint clean with an empty baseline, and the port's
wire-ABI lockfile, its own copy beside its baseline, must equal
corpus/wire/ABI.lock byte for byte: the port's message set has the
reference's wire ABI.  Every fixture of tests/test_lint.py (a doctored
types.py against the committed lockfile, a blocking call in a coroutine, an
unknown config key, a struct arity mismatch, ...) goes through both
packages' checkers, and the findings must be the same: check, key, file and
message, with the port's paths mapped to the reference's (a file's line
numbers differ by the port's copy header, so ``path:line`` in a message is
compared without its line).
"""

import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import types

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "ceph_tpu", "ceph_tpu_torch"
PORT_LOCK = os.path.join("ceph_tpu_torch", "tools", "lint", "ABI.lock")
REF_LOCK = os.path.join("corpus", "wire", "ABI.lock")


def lint(prefix):
    imp = lambda name: importlib.import_module(f"{prefix}.tools.{name}")  # noqa: E731
    return types.SimpleNamespace(
        prefix=prefix, pkg=imp("lint"), wire_abi=imp("lint.wire_abi"),
        async_safety=imp("lint.async_safety"), registry=imp("lint.registry"),
        codec=imp("lint.codec"), findings=imp("lint.findings"),
        wire_corpus=imp("wire_corpus"))


def as_reference(text):
    """A port path or message in the reference's terms."""
    text = text.replace(PORT_LOCK, REF_LOCK)
    text = re.sub(r"\bceph_tpu_torch\b", "ceph_tpu", text)
    return re.sub(r"(\.py):\d+", r"\1", text)


def records(findings):
    return sorted((f.check, as_reference(f.file), f.key,
                   as_reference(f.message)) for f in findings)


# -- the fixtures of tests/test_lint.py, one function each -------------------


def types_sources(L, mutate):
    sources = []
    for rel in L.wire_abi.WIRE_SOURCES:
        with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
            text = fh.read()
        if rel.endswith("types.py"):
            text = mutate(text)
        sources.append((rel, text))
    return sources


def wire_check(L, mutate):
    return L.wire_abi.check(REPO, lock_path=L.pkg.WIRE_LOCK_PATH,
                            sources=types_sources(L, mutate), coverage=False)


def swap_needle(needle, replacement):
    def mutate(text):
        assert needle in text
        return text.replace(needle, replacement)
    return mutate


TAIL = swap_needle('    ("gseq", "Q"),\n]\n# a compound op vector',
                   '    ("gseq", "Q"),\n    ("sneaky", "Q"),\n]\n'
                   '# a compound op vector')


def tail_with_bump(text):
    text = TAIL(text).replace("@message(20, version=7)",
                              "@message(20, version=8)")
    return text.replace("    gseq: int = 0\n\n\n@message(21",
                        "    gseq: int = 0\n    sneaky: int = 0\n\n\n"
                        "@message(21")


WIRE_CASES = {
    "clean": (lambda t: t, None),
    "field_reorder": (swap_needle(
        '("pool_id", "q"), ("pg", "q"), ("from_osd", "q"), ("epoch", "q"),',
        '("pg", "q"), ("pool_id", "q"), ("from_osd", "q"), ("epoch", "q"),'),
        "wire-abi/layout-break"),
    "field_removal": (swap_needle('("snap_read", "Q"), ("snap_id", "Q"),',
                                  '("snap_id", "Q"),'),
                      "wire-abi/layout-break"),
    "tail_without_version_bump": (TAIL,
                                  "wire-abi/tail-without-version-bump"),
    "tail_with_bump": (tail_with_bump, None),
    "duplicate_and_changed_id": (
        lambda t: t.replace("@message(48)", "@message(47)"),
        "wire-abi/duplicate-id"),
    "message_removal": (
        lambda t: t.replace("@message(17)\nclass MOSDPing:",
                            "class MOSDPing:"), "wire-abi/removed"),
    "unlocked_addition": (
        lambda t: t + ("\n\n@message(9999)\nclass MBrandNew:\n"
                       "    tid: str = \"\"\n"), "wire-abi/unlocked"),
}

ASYNC_CASES = {
    "blocking_sleep": ("import time\nasync def tick():\n    time.sleep(1.0)\n",
                       "async-safety/blocking-call"),
    "async_sleep": ("import asyncio\nasync def tick():\n"
                    "    await asyncio.sleep(1.0)\n", None),
    "sync_sleep": ("import time\ndef worker():\n    time.sleep(1.0)\n", None),
    "blocking_acquire": ("async def go(self):\n    self._lock.acquire()\n",
                         "async-safety/blocking-call"),
    "awaited_acquire": ("async def go(self):\n"
                        "    await self._alock.acquire()\n", None),
    "lock_across_await": ("async def go(self):\n    with self._lock:\n"
                          "        await self.flush()\n",
                          "async-safety/lock-across-await"),
    "release_before_await": ("async def go(self):\n    with self._lock:\n"
                             "        n = self.count\n"
                             "    await self.flush(n)\n", None),
    "open_across_await": ("async def go(self):\n"
                          "    with open('f') as fh:\n"
                          "        await self.flush(fh)\n", None),
    "cross_loop_call": ("def on_thread(self, coro):\n"
                        "    self.loop.create_task(coro)\n",
                        "async-safety/cross-loop-call"),
    "threadsafe_wrap": ("def on_thread(self, coro):\n"
                        "    self.loop.call_soon_threadsafe(\n"
                        "        lambda: self.loop.create_task(coro))\n", None),
    "running_loop": ("import asyncio\ndef sync_cb(self, coro):\n"
                     "    asyncio.get_running_loop().create_task(coro)\n",
                     None),
    "local_running_loop": ("import asyncio\ndef sync_cb(self, coro):\n"
                           "    loop = asyncio.get_running_loop()\n"
                           "    loop.create_task(coro)\n", None),
}

REGISTRY_CASES = {
    "unknown_config_key": (
        "fixture.py", "def f(self):\n"
        "    return self.conf.get(\"osd_definitely_not_an_option\", 1)\n",
        "registry/unknown-config-key"),
    "plain_dict_get": ("fixture.py",
                       "def f(cfg):\n    return cfg.get(\"Status\")\n", None),
    "undeclared_perf_counter": (
        "fixture.py", "def f(self):\n"
        "    self.perf.inc(\"no_such_counter_xyz\")\n",
        "registry/undeclared-perf-counter"),
    "orphan_asok_renderer": (
        "CEPH_TOOL", "ASOK_RENDERERS = {\"dump_ghost_cmd\": None}\n",
        "registry/orphan-asok-renderer"),
}

SLAB = ("import numpy as np\ndef serve(store, key):\n"
        "    bits = store.gather_rows(key, 0, 8)\n")
CODEC_CASES = {
    "struct_arity": ("import struct\ndef f(a, b):\n"
                     "    return struct.pack(\"<HH\", a, b, 3)\n",
                     "codec/struct-arity"),
    "struct_object_ok": ("import struct\nHDR = struct.Struct(\"<HHBI\")\n"
                         "def f(a, b, c, d):\n"
                         "    return HDR.pack(a, b, c, d)\n", None),
    "struct_object_arity": ("import struct\nHDR = struct.Struct(\"<HHBI\")\n"
                            "def f(a, b, c):\n    return HDR.pack(a, b, c)\n",
                            "codec/struct-arity"),
    "slab_asarray": (SLAB + "    return np.asarray(bits)\n",
                     "codec/slab-host-roundtrip"),
    "slab_copy": (SLAB + "    return bits.copy()\n",
                  "codec/slab-host-roundtrip"),
    "slab_direct": ("import numpy as np\ndef serve(store, key):\n"
                    "    return np.frombuffer(store.gather_rows(key, 0, 8))\n",
                    "codec/slab-host-roundtrip"),
    "slab_boundary": ("import numpy as np\nSLAB_IO_BOUNDARY = (\"serve\",)\n"
                      "def serve(store, key):\n"
                      "    bits = store.gather_rows(key, 0, 8)\n"
                      "    return np.asarray(bits)\n", None),
    "slab_untainted": ("import numpy as np\n"
                       "def serve(store, key, other):\n"
                       "    bits = store.gather_rows(key, 0, 8)\n"
                       "    decode(bits)\n    return np.asarray(other)\n"
                       "def decode(bits):\n    return bits\n", None),
}

FIXED_CASES = {
    "fixed_field_hygiene": (
        "@message(9000, version=2)\nclass MBad:\n    a: int = 0\n"
        "    FIXED_FIELDS = [(\"a\", \"q\"), (\"ghost\", \"s\"),\n"
        "                    (\"a\", \"zz\")]\n", "codec/fixed-field"),
    "fixed_tail_default": (
        "@message(9001, version=2)\nclass MNoDefault:\n    a: int\n"
        "    FIXED_FIELDS = [(\"a\", \"q\")]\n", "codec/fixed-tail-default"),
}


def run_case(L, family, name, tmp_path):
    if family == "wire":
        return wire_check(L, WIRE_CASES[name][0])
    if family == "coverage":
        return L.wire_abi.check(REPO, lock_path=L.pkg.WIRE_LOCK_PATH,
                                corpus_dir=str(tmp_path))
    if family == "async":
        return L.async_safety.check([("fixture.py", ASYNC_CASES[name][0])])
    if family == "registry":
        path, src, _ = REGISTRY_CASES[name]
        if path == "CEPH_TOOL":
            path = L.registry.CEPH_TOOL_REL
        return L.registry.check(REPO, [(path, src)])
    if family == "codec":
        return L.codec.check([("fixture.py", CODEC_CASES[name][0])])
    return L.codec.check([], wire_sources=[("fixture.py",
                                            FIXED_CASES[name][0])])


CASES = ([("wire", n, c) for n, (_, c) in WIRE_CASES.items()]
         + [("coverage", "empty_corpus", "wire-abi/coverage")]
         + [("async", n, c) for n, (_, c) in ASYNC_CASES.items()]
         + [("registry", n, c) for n, (_, _, c) in REGISTRY_CASES.items()]
         + [("codec", n, c) for n, (_, c) in CODEC_CASES.items()]
         + [("fixed", n, c) for n, (_, c) in FIXED_CASES.items()])


@pytest.mark.parametrize("family,name,expected", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_fixture_findings_equal_the_reference(family, name, expected,
                                              tmp_path):
    ref = records(run_case(lint(REF), family, name, tmp_path))
    port = records(run_case(lint(PORT), family, name, tmp_path))
    assert port == ref
    if expected is None:
        assert port == [], port
    else:
        assert expected in {r[0] for r in port}, port


# -- the port's own tree -----------------------------------------------------


def test_port_tree_is_clean_with_an_empty_baseline():
    L = lint(PORT)
    with open(L.pkg.BASELINE_PATH) as f:
        assert json.load(f) == {"suppressions": []}
    report = L.pkg.run_lint()
    assert report.files_scanned > 100
    assert not report.suppressed
    assert report.findings == [], "\n".join(
        f.render() for f in report.findings)


def test_port_lint_scopes_the_port_tree():
    L = lint(PORT)
    files = L.pkg._py_files(REPO, None)
    assert files and all(
        os.path.relpath(p, REPO).startswith("ceph_tpu_torch" + os.sep)
        for p in files)
    assert L.registry.CONFIG_REL == os.path.join("ceph_tpu_torch", "common",
                                                 "config.py")
    assert all(rel.startswith("ceph_tpu_torch" + os.sep)
               for rel in L.wire_abi.WIRE_SOURCES)


def test_cli_exit_status_and_json():
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--json"],
        capture_output=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stdout.decode() + out.stderr.decode()
    doc = json.loads(out.stdout)
    assert doc["ok"] is True and doc["findings"] == []


def test_lock_copy_is_the_reference_lock_byte_for_byte():
    L = lint(PORT)
    assert L.pkg.WIRE_LOCK_PATH == os.path.join(REPO, PORT_LOCK)
    with open(os.path.join(REPO, PORT_LOCK), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, REF_LOCK), "rb") as f:
        assert port == f.read()


def test_lock_copy_matches_the_port_declarations():
    L = lint(PORT)
    sources = []
    for rel in L.wire_abi.WIRE_SOURCES:
        with open(os.path.join(REPO, rel), encoding="utf-8") as fh:
            sources.append((rel, fh.read()))
    current = L.wire_abi.make_lock(L.wire_abi.extract(sources))
    with open(L.pkg.WIRE_LOCK_PATH, encoding="utf-8") as fh:
        assert current["messages"] == json.load(fh)["messages"]


def test_update_wire_lock_writes_the_port_copy_only(tmp_path):
    """--update-wire-lock under a root writes the lint's own ABI.lock
    there and nothing under corpus/."""
    L = lint(PORT)
    for rel in L.wire_abi.WIRE_SOURCES:
        os.makedirs(tmp_path / os.path.dirname(rel), exist_ok=True)
        shutil.copy(os.path.join(REPO, rel), tmp_path / rel)
    os.makedirs(tmp_path / os.path.dirname(PORT_LOCK))
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--root",
         str(tmp_path), "--update-wire-lock"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not (tmp_path / "corpus").exists()
    with open(tmp_path / PORT_LOCK) as f:
        written = json.load(f)
    with open(os.path.join(REPO, REF_LOCK)) as f:
        assert written["messages"] == json.load(f)["messages"]


def test_coverage_walk_equals_the_reference(tmp_path):
    gaps = {}
    for prefix in (REF, PORT):
        wc = lint(prefix).wire_corpus
        assert wc.coverage_gaps() == []
        gaps[prefix] = sorted((g.type_name, g.kind, as_reference(g.file),
                               as_reference(g.message))
                              for g in wc.coverage_gaps(str(tmp_path)))
        assert len(wc.fixed_types()) == 24
    assert gaps[PORT] == gaps[REF]
    kinds = {(g[0], g[1]) for g in gaps[PORT]}
    assert ("MOSDOp", "golden") in kinds and ("MLaneHello", "corpus") in kinds


# -- baseline mechanics on the port ------------------------------------------


def test_stale_baseline_entry_is_a_finding(tmp_path):
    L = lint(PORT)
    bl_path = tmp_path / "baseline.json"
    L.findings.Baseline([L.findings.BaselineEntry(
        check="registry/unknown-config-key", file="gone.py",
        key="long_fixed_key", reason="was fixed")]).save(str(bl_path))
    report = L.pkg.run_lint(baseline_path=str(bl_path), checks=("registry",))
    assert any(f.check == "baseline/stale" for f in report.findings)
    report = L.pkg.run_lint(baseline_path=str(bl_path), checks=("codec",))
    assert not any(f.check == "baseline/stale" for f in report.findings)


def test_todo_baseline_reason_is_a_finding(tmp_path):
    L = lint(PORT)
    fx = tmp_path / "fixture.py"
    fx.write_text("import struct\ndef f(a):\n"
                  "    return struct.pack(\"<HH\", a)\n")
    bl_path = tmp_path / "baseline.json"
    entry = L.findings.BaselineEntry(
        check="codec/struct-arity", file="fixture.py", key="<HH@L3",
        reason="TODO: justify this suppression in one line")
    L.findings.Baseline([entry]).save(str(bl_path))
    report = L.pkg.run_lint(root=str(tmp_path), paths=[str(fx)],
                            checks=("codec",), baseline_path=str(bl_path))
    assert [f.check for f in report.findings] == ["baseline/unjustified"]
    entry.reason = "fixture: deliberate arity mismatch"
    L.findings.Baseline([entry]).save(str(bl_path))
    report = L.pkg.run_lint(root=str(tmp_path), paths=[str(fx)],
                            checks=("codec",), baseline_path=str(bl_path))
    assert report.findings == []


def test_cli_nonzero_on_violations(tmp_path):
    rados = tmp_path / "ceph_tpu_torch" / "rados"
    rados.mkdir(parents=True)
    (rados / "types.py").write_text("import struct\ndef f(a):\n"
                                    "    return struct.pack(\"<HH\", a)\n")
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--root",
         str(tmp_path), "--no-baseline", "--checks", "codec", str(rados)],
        capture_output=True, cwd=REPO, timeout=300)
    assert out.returncode == 1
    assert b"struct-arity" in out.stderr
