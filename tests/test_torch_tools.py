"""The port's offline and operator tools against ceph_tpu's, on the CPU.

- non_regression --create writes the same archive (content and every
  chunk) in both packages, plugin=cuda's equal to plugin=tpu's; the port's
  --check replays every committed corpus archive, the plugin=tpu one under
  plugin=cuda on both lanes (its chunks are jerasure reed_sol_van's);
- bench_suite sweeps the same cells;
- --wire-floor's record half (the lane half stubbed, as
  tests/test_tools.py's TestWireFloor does; the gates' files run it);
- one script of the ``ceph`` CLI (status, health, osd tree, pg dump, df,
  osd df, the pool lifecycle, an OSD lost) on a disk-backed cluster of each
  package, outputs equal but for the osdmap epoch, then the stopped cluster's mon store through both
  monstore tools and an OSD store through both objectstore tools, and the
  stitched trace of one put; the reference's stores read by the port go
  through rados/unpickle.py;
- cephadm bootstrap/ls/stop/rm-cluster and orch-apply on the port, the
  deployed cluster reached by the port's ceph CLI in another process;
- dencoder, ceph_volume and trace_export as tests/test_mgr_tools.py,
  tests/test_ceph_volume.py and tests/test_op_tracking.py drive them, the
  outputs equal across the packages;
- ``python -m ceph_tpu_torch.rados.vstart --device cpu`` starts a cluster,
  and without a device flag it refuses on a host with no card.

The port runs with ``--device cpu`` (its OSDs with ``osd_ec_device:
cpu``); the reference's plugin=tpu runs on JAX's CPU backend.
"""

import asyncio
import contextlib
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "corpus")
REF, PORT = "ceph_tpu", "ceph_tpu_torch"
CONF = {"osd_auto_repair": False, "osd_heartbeat_interval": 0.1,
        "mon_osd_report_grace": 1.0, "ms_local_fastpath": False}
DEVICE_CONF = {REF: {}, PORT: {"osd_ec_device": "cpu"}}
DEVICE_ARGS = {REF: [], PORT: ["--device", "cpu"]}
EC_PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
              "k": "2", "m": "1"}


def tools(prefix):
    imp = lambda name: importlib.import_module(f"{prefix}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        prefix=prefix, Cluster=imp("rados.vstart").Cluster,
        BlueStore=imp("rados.bluestore").BlueStore,
        store=imp("rados.store"),
        non_regression=imp("tools.non_regression"),
        bench_suite=imp("tools.bench_suite"), ceph=imp("tools.ceph"),
        cephadm=imp("tools.cephadm"), ceph_volume=imp("tools.ceph_volume"),
        dencoder=imp("tools.dencoder"),
        monstore_tool=imp("tools.monstore_tool"),
        objectstore_tool=imp("tools.objectstore_tool"),
        trace_export=imp("tools.trace_export"))


def captured(main, argv):
    """(rc, stdout) of one in-process tool run."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def corpus_dirs():
    return sorted(d for d in os.listdir(CORPUS) if d.startswith("plugin="))


def archive_args(profile_dir):
    parts = profile_dir.split()
    argv = ["--stripe-width", parts[1].split("=", 1)[1]]
    for kv in parts[2:]:
        argv += ["-P", kv]
    return parts[0].split("=", 1)[1], argv


# -- non_regression: corpus ---------------------------------------------------


CREATE_CASES = [
    ("jerasure", "jerasure", ["-P", "technique=reed_sol_van", "-P", "k=4",
                              "-P", "m=2"], 8192),
    ("jerasure", "jerasure", ["-P", "technique=cauchy_good", "-P", "k=4",
                              "-P", "m=2"], 4096),
    ("isa", "isa", ["-P", "technique=reed_sol_van", "-P", "k=8",
                    "-P", "m=3"], 4096),
    ("shec", "shec", ["-P", "k=4", "-P", "m=3", "-P", "c=2"], 4096),
    ("lrc", "lrc", ["-P", "k=4", "-P", "m=2", "-P", "l=3"], 4096),
    ("clay", "clay", ["-P", "k=4", "-P", "m=2", "-P", "d=5"], 4096),
    ("tpu", "cuda", ["-P", "technique=reed_sol_van", "-P", "k=8",
                     "-P", "m=3"], 4096),
    ("tpu", "cuda", ["-P", "technique=cauchy_good", "-P", "k=4",
                     "-P", "m=2"], 4096),
]


@pytest.mark.parametrize("ref_plugin,port_plugin,params,width", CREATE_CASES,
                         ids=[f"{c[1]}-{'-'.join(c[2][1::2])}"
                              for c in CREATE_CASES])
def test_create_writes_the_reference_archive(tmp_path, ref_plugin,
                                             port_plugin, params, width):
    written = {}
    for prefix, plugin in ((REF, ref_plugin), (PORT, port_plugin)):
        base = tmp_path / prefix
        argv = (["--plugin", plugin, "--base", str(base), "--stripe-width",
                 str(width)] + params + DEVICE_ARGS[prefix])
        nr = tools(prefix).non_regression
        assert nr.main(argv + ["--create"]) == 0
        assert nr.main(argv + ["--check"]) == 0
        (archive,) = os.listdir(base)
        assert archive.startswith(f"plugin={plugin} stripe-width={width} ")
        written[prefix] = {name: (base / archive / name).read_bytes()
                           for name in os.listdir(base / archive)}
    assert written[PORT] == written[REF]
    assert len(written[PORT]) > 1


def test_create_check_detects_a_corrupt_chunk(tmp_path):
    nr = tools(PORT).non_regression
    argv = ["--plugin", "cuda", "--base", str(tmp_path), "--device", "cpu",
            "-P", "k=4", "-P", "m=2", "-P", "technique=reed_sol_van"]
    assert nr.main(argv + ["--create"]) == 0
    d = tmp_path / "plugin=cuda stripe-width=4096 k=4 m=2 technique=reed_sol_van"
    with open(d / "2", "r+b") as f:
        f.write(b"\xff\xff")
    assert nr.main(argv + ["--check"]) == 1
    # profile errors exit 1 with a message, not a traceback
    assert nr.main(["--plugin", "lrc", "--base", str(tmp_path),
                    "--create"]) == 1


REPLAYS = [(d, "1") for d in corpus_dirs()] + [
    (d, "0") for d in corpus_dirs() if d.startswith("plugin=tpu")]


@pytest.mark.parametrize("profile_dir,packedbit", REPLAYS,
                         ids=[f"{d.split()[0]}-{' '.join(d.split()[2:])}"
                              f"-packedbit{p}" for d, p in REPLAYS])
def test_port_replays_the_committed_corpus(profile_dir, packedbit,
                                           monkeypatch):
    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", packedbit)
    plugin, argv = archive_args(profile_dir)
    if plugin == "tpu":
        plugin = "cuda"
    assert tools(PORT).non_regression.main(
        ["--check", "--base", CORPUS, "--plugin", plugin, "--device", "cpu"]
        + argv) == 0


def test_corpus_replay_needs_a_card_or_a_named_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, argv = archive_args(next(d for d in corpus_dirs()
                                if d.startswith("plugin=tpu")))
    rc = tools(PORT).non_regression.main(
        ["--check", "--base", CORPUS, "--plugin", "cuda"] + argv)
    assert rc == 1


# -- bench_suite ---------------------------------------------------------------


def test_bench_suite_sweeps_the_reference_cells():
    cells = {}
    for prefix, device_plugin in ((REF, "tpu"), (PORT, "cuda")):
        rc, out = captured(tools(prefix).bench_suite.main, [
            "--size", "16384", "--iterations", "1", "--plugins",
            f"jerasure,{device_plugin}", "--ks", "2",
            "--workloads", "encode,decode"] + DEVICE_ARGS[prefix])
        assert rc == 0
        rows = [json.loads(line) for line in out.strip().splitlines()]
        assert all(r["mbps"] > 0 for r in rows)
        cells[prefix] = [(r["plugin"].replace("tpu", "cuda"), r["technique"],
                          r["k"], r["m"], r["workload"], r["kb"])
                         for r in rows]
    assert cells[PORT] == cells[REF]
    assert len(cells[PORT]) == 16
    bs = tools(PORT).bench_suite
    assert bs.parse_args([]).plugins == "jerasure,isa,cuda"
    assert bs.TECHNIQUES["cuda"] == tools(REF).bench_suite.TECHNIQUES["tpu"]


# -- --wire-floor's record half (tests/test_tools.py TestWireFloor) ----------


class TestWireFloor:
    def _write(self, path, put, get, wrapped=False, kind=None,
               put_py=None, get_py=None):
        rec = {"daemon_wire_put_MBps": put, "daemon_wire_get_MBps": get}
        if kind is not None:
            rec["wirepath_kind"] = kind
        if put_py is not None:
            rec["daemon_wire_put_MBps_python"] = put_py
        if get_py is not None:
            rec["daemon_wire_get_MBps_python"] = get_py
        if wrapped:
            rec = {"n": 5, "parsed": rec}
        path.write_text(json.dumps(rec))

    @pytest.fixture(autouse=True)
    def _stub_lane_identity(self, monkeypatch):
        self.nr = tools(PORT).non_regression
        self.lane_calls = []
        monkeypatch.setattr(self.nr, "_wire_lane_identity",
                            lambda device: self.lane_calls.append(device)
                            or 0)

    def main(self, argv):
        return self.nr.main(argv + ["--device", "cpu"])

    def test_regression_fails_healthy_passes(self, tmp_path, capsys):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        self._write(prev, 200.0, 300.0, wrapped=True)
        self._write(cur, 210.0, 100.0)
        argv = ["--wire-floor", "--bench", str(cur), "--prev", str(prev)]
        assert self.main(argv) == 1
        out = capsys.readouterr().out
        assert "FAIL wire-floor: daemon_wire_get_MBps" in out
        assert "daemon_wire_put_MBps [python arms] 210.0" in out
        self._write(cur, 210.0, 290.0)
        assert self.main(argv) == 0
        assert "FAIL" not in capsys.readouterr().out
        assert self.lane_calls == ["cpu", "cpu"]

    def test_lane_identity_failure_fails_gate(self, tmp_path, monkeypatch):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        self._write(prev, 200.0, 300.0)
        self._write(cur, 210.0, 290.0)
        monkeypatch.setattr(self.nr, "_wire_lane_identity", lambda device: 1)
        assert self.main(["--wire-floor", "--bench", str(cur),
                          "--prev", str(prev)]) == 1

    def test_missing_previous_metric_skips(self, tmp_path, capsys):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        prev.write_text("{}")
        self._write(cur, 100.0, 100.0)
        assert self.main(["--wire-floor", "--bench", str(cur),
                          "--prev", str(prev)]) == 0
        assert "skipping" in capsys.readouterr().out

    def test_lane_identity_runs_without_records(self):
        assert self.main(["--wire-floor"]) == 0
        assert self.lane_calls == ["cpu"]

    def test_unreadable_record_fails(self, tmp_path):
        cur = tmp_path / "cur.json"
        self._write(cur, 1.0, 1.0)
        assert self.main(["--wire-floor", "--bench", str(cur),
                          "--prev", str(tmp_path / "nope.json")]) == 1

    def test_differing_arms_compare_python_numbers(self, tmp_path, capsys):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        self._write(prev, 200.0, 300.0)
        self._write(cur, 400.0, 500.0, kind="native", put_py=90.0,
                    get_py=290.0)
        argv = ["--wire-floor", "--bench", str(cur), "--prev", str(prev)]
        assert self.main(argv) == 1
        out = capsys.readouterr().out
        assert "wirepath_kind differs" in out
        assert "FAIL wire-floor: daemon_wire_put_MBps" in out
        self._write(cur, 400.0, 500.0, kind="native", put_py=195.0,
                    get_py=290.0)
        assert self.main(argv) == 0
        assert "FAIL" not in capsys.readouterr().out

    def test_matching_native_arms_compare_headline(self, tmp_path, capsys):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        self._write(prev, 400.0, 500.0, wrapped=True, kind="native",
                    put_py=200.0, get_py=250.0)
        self._write(cur, 250.0, 480.0, kind="native", put_py=210.0,
                    get_py=260.0)
        assert self.main(["--wire-floor", "--bench", str(cur),
                          "--prev", str(prev)]) == 1
        out = capsys.readouterr().out
        assert "[native arms]" in out
        assert "FAIL wire-floor: daemon_wire_put_MBps" in out

    def test_native_record_missing_python_arm_fails(self, tmp_path, capsys):
        prev, cur = tmp_path / "prev.json", tmp_path / "cur.json"
        self._write(prev, 200.0, 300.0)
        self._write(cur, 400.0, 500.0, kind="native")
        assert self.main(["--wire-floor", "--bench", str(cur),
                          "--prev", str(prev)]) == 1
        assert "missing in the current record" in capsys.readouterr().out


# -- the ceph CLI, the store tools and trace_export on both packages ---------


def blob(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


async def ceph_script(T, data_dir):
    """The ceph CLI over one disk-backed cluster: what tests/test_tools.py's
    TestCephStatusCli and TestPoolLifecycleCli and tests/test_mgr_tools.py's
    TestOsdDf ask of it.  Returns every command's (words, format, rc,
    output) and the span names of one put's stitched trace."""
    out = []
    cluster = T.Cluster(n_osds=4, conf=dict(CONF, **DEVICE_CONF[T.prefix]),
                        data_dir=data_dir)
    await cluster.start()
    try:
        c = await cluster.client()
        pool = await c.create_pool("st", profile=dict(EC_PROFILE))
        for i in range(3):
            await c.put(pool, f"o{i}", blob(9000, i))
        mon = f"{cluster.mons[0].addr[0]}:{cluster.mons[0].addr[1]}"

        async def cli(*words, fmt="json", record=True):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = await T.ceph.run(T.ceph.parse_args(
                    ["--mon", mon, "--format", fmt, *words]))
            if record:
                out.append((words, fmt, rc, buf.getvalue()))
            return rc, buf.getvalue()

        # the mon's osd df view fills on the ping cadence: wait until it
        # counts every shard (3 objects x 3 shards)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            _, text = await cli("osd", "df", record=False)
            if sum(r.get("num_objects", 0) for r in json.loads(text)) == 9:
                break
            await asyncio.sleep(0.1)
        for words in (("status",), ("health",), ("osd", "tree"),
                      ("pg", "dump"), ("df",), ("osd", "df")):
            await cli(*words)
        await cli("osd", "pool", "create", "data", "k=2", "m=1", fmt="plain")
        await cli("osd", "pool", "ls")
        await cli("osd", "pool", "set", "data", "pg_num", "16", fmt="plain")
        _, text = await cli("osd", "pool", "ls")
        data_id = [p for p in json.loads(text) if p["name"] == "data"][0]["id"]
        await c.refresh_map()
        await c.put(data_id, "doomed", b"bytes" * 100)
        await cli("osd", "pool", "rm", "data", "data", fmt="plain")
        await cli("osd", "pool", "rm", "data", "typo",
                  "--yes-i-really-really-mean-it", fmt="plain")
        await cli("osd", "pool", "rm", "data", "data",
                  "--yes-i-really-really-mean-it", fmt="plain")
        await cli("osd", "pool", "ls")
        await cli("status", fmt="plain")
        await cli("osd", "tree", fmt="plain")
        # one put's stitched trace
        await c.put(pool, "traced", blob(300_000, 9))
        root = [d for d in c.tracer.dump()
                if d["name"] == "client_op write traced"][-1]
        spans = T.trace_export.collect_spans(
            [c.tracer] + [o.ctx.tracer for o in cluster.osds.values()],
            root["trace_id"])
        links = T.trace_export.resolve_parents(spans)
        doc = T.trace_export.to_jaeger(root["trace_id"], spans)
        trace = {"names": sorted(s["name"] for s in spans),
                 "orphans": links["__orphans__"],
                 "jaeger_spans": len(doc["data"][0]["spans"]),
                 "roots": [s["name"] for s in spans if not s["parent_id"]]}
        # an OSD lost: health degrades, the tree shows it down
        victim = max(cluster.osds)
        await cluster.kill_osd(victim)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            _, text = await cli("health", record=False)
            if "OSD_DOWN" in json.loads(text).get("checks", {}):
                break
            await asyncio.sleep(0.1)
        _, text = await cli("health", record=False)
        out.append((("health", "checks"), "json", 0,
                    sorted(json.loads(text)["checks"])))
        await cli("osd", "tree")
        await c.stop()
    finally:
        await cluster.stop()
    return out, trace


@pytest.fixture(scope="module")
def stopped_clusters(tmp_path_factory):
    """Each package's CLI script, run once, and the directory its stopped
    cluster left."""
    runs = {}
    for prefix in (REF, PORT):
        data_dir = str(tmp_path_factory.mktemp(f"cluster-{prefix}"))
        script, trace = asyncio.run(asyncio.wait_for(
            ceph_script(tools(prefix), data_dir), 120))
        runs[prefix] = types.SimpleNamespace(script=script, trace=trace,
                                             data_dir=data_dir)
    return runs


def mask_epochs(text):
    """The osdmap epoch counts map changes, which the mon may batch
    differently from run to run."""
    text = re.sub(r'"epoch": \d+', '"epoch": E', str(text))
    return re.sub(r"osdmap: e\d+:", "osdmap: eE:", text)


def test_ceph_cli_script_output_equals_the_reference(stopped_clusters):
    ref, port = (stopped_clusters[p].script for p in (REF, PORT))
    assert [r[:3] for r in port] == [r[:3] for r in ref]
    for (words, fmt, rc, want), (_, _, _, got) in zip(ref, port):
        assert mask_epochs(got) == mask_epochs(want), words
    first = {}
    for r in port:
        first.setdefault((r[0], r[1]), r)
    st = json.loads(first[("status",), "json"][3])
    assert st["health"] == "HEALTH_OK" and st["osdmap"]["num_up_osds"] == 4
    assert "OSD_DOWN" in first[("health", "checks"), "json"][3]
    df = json.loads(first[("osd", "df"), "json"][3])
    assert sum(r["num_objects"] for r in df) == 9
    assert [rc for w, _, rc, _ in port if w[:3] == ("osd", "pool", "rm")] \
        == [1, 1, 0]


def test_trace_of_one_put_equals_the_reference(stopped_clusters):
    ref, port = (stopped_clusters[p].trace for p in (REF, PORT))
    assert port == ref
    assert port["orphans"] == 0 and port["roots"] == ["client_op write traced"]
    assert {"osd_op write", "ec write"} <= set(port["names"])


@pytest.mark.parametrize("store_of", [REF, PORT])
def test_monstore_tool_equals_the_reference(stopped_clusters, store_of,
                                            tmp_path):
    """Both packages' monstore tools on one stopped mon's store; the
    reference's store reaches the port through its unpickler."""
    src = os.path.join(stopped_clusters[store_of].data_dir, "mon.0")
    outs = {}
    for prefix in (REF, PORT) if store_of == REF else (PORT,):
        shutil.copytree(src, tmp_path / prefix)
        path = str(tmp_path / prefix / "store.db")
        mst = tools(prefix).monstore_tool
        rc, dump = captured(mst.main, [path, "dump"])
        assert rc == 0
        last = json.loads(dump)["last_committed"]
        rc, state = captured(mst.main, [path, "get-state"])
        assert rc == 0
        assert any(p["name"] == "st"
                   for p in json.loads(state)["pools"].values())
        rc, _ = captured(mst.main, [path, "rewrite", str(last - 1)])
        assert rc == 0
        rc, dump2 = captured(mst.main, [path, "dump"])
        assert json.loads(dump2)["last_committed"] == last - 1
        outs[prefix] = (dump, state, dump2)
    if store_of == REF:
        assert outs[PORT] == outs[REF]


@pytest.mark.parametrize("store_of", [REF, PORT])
def test_objectstore_tool_equals_the_reference(stopped_clusters, store_of):
    """Both packages' objectstore tools list and describe one stopped OSD's
    BlueStore; the reference's reaches the port through its unpickler."""
    path = os.path.join(stopped_clusters[store_of].data_dir, "osd.0")
    outs = {}
    for prefix in (REF, PORT) if store_of == REF else (PORT,):
        ost = tools(prefix).objectstore_tool
        rc, listing = captured(ost.main, ["--data-path", path, "--op", "list"])
        assert rc == 0 and listing.strip()
        first = json.loads(listing.splitlines()[0])
        rc, info = captured(ost.main, [
            "--data-path", path, "--op", "info", "--pool", str(first["pool"]),
            "--oid", first["oid"], "--shard", str(first["shard"])])
        assert rc == 0
        rc, statfs = captured(ost.main, ["--data-path", path, "--op",
                                         "statfs"])
        assert rc == 0
        outs[prefix] = (listing, info, statfs)
    if store_of == REF:
        assert outs[PORT] == outs[REF]


def test_objectstore_tool_export_import_round_trip(tmp_path):
    """tests/test_mgr_tools.py's TestObjectstoreTool on the port."""
    T = tools(PORT)
    ost = T.objectstore_tool
    path = str(tmp_path / "osd0")
    store = T.BlueStore(path)
    t = T.store.Transaction()
    t.write((1, "obj", 0), b"DATA" * 100,
            T.store.ShardMeta(version=7, object_size=400))
    store.queue_transaction(t)
    store.setattr((1, "obj", 0), "hinfo", b"\x01")
    store.omap_set((1, "obj", 0), {"k": b"v"})
    store.close()
    exp = str(tmp_path / "exp.bin")
    for argv in (["--op", "list"],
                 ["--op", "info", "--pool", "1", "--oid", "obj"],
                 ["--op", "export", "--pool", "1", "--oid", "obj",
                  "--file", exp],
                 ["--op", "remove", "--pool", "1", "--oid", "obj"]):
        assert captured(ost.main, ["--data-path", path] + argv)[0] == 0
    s2 = T.BlueStore(path)
    assert s2.read((1, "obj", 0)) is None
    s2.close()
    assert captured(ost.main, ["--data-path", path, "--op", "import",
                               "--file", exp])[0] == 0
    s3 = T.BlueStore(path)
    data, meta = s3.read((1, "obj", 0))
    assert data == b"DATA" * 100 and meta.version == 7
    assert s3.getattr((1, "obj", 0), "hinfo") == b"\x01"
    assert s3.omap_get((1, "obj", 0)) == {"k": b"v"}
    s3.close()


# -- dencoder, ceph_volume ------------------------------------------------------


def dencoder_cli(prefix, *argv):
    """(rc, stdout) of the package's dencoder in a process of its own: its
    message registry holds the package's types only (test modules
    collected into this process register fixture types of their own)."""
    out = subprocess.run(
        [sys.executable, "-m", f"{prefix}.tools.dencoder", *argv],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return out.returncode, out.stdout


@pytest.mark.parametrize("argv", [["list"], ["roundtrip"], ["golden"]],
                         ids=lambda a: a[0])
def test_dencoder_equals_the_reference(argv):
    outs = [dencoder_cli(p, *argv) for p in (REF, PORT)]
    assert outs[1] == outs[0]
    assert outs[1][0] == 0


def test_dencoder_corpus_write_check_and_regression(tmp_path):
    outs = {}
    for prefix in (REF, PORT):
        corpus = str(tmp_path / f"{prefix}.json")
        assert dencoder_cli(prefix, "corpus", "--write", corpus)[0] == 0
        assert dencoder_cli(prefix, "corpus", "--check", corpus)[0] == 0
        with open(corpus) as f:
            snap = json.load(f)
        outs[prefix] = json.loads(json.dumps(snap))
        snap["MOSDOp"]["version"] += 5
        snap["MOSDOp"]["fields"].append("ghost_field")
        with open(corpus, "w") as f:
            json.dump(snap, f)
        rc, out = dencoder_cli(prefix, "corpus", "--check", corpus)
        assert rc == 1
        assert "VERSION REGRESSION" in out and "FIELDS REMOVED" in out
    assert outs[PORT] == outs[REF]


def test_ceph_volume_equals_the_reference(tmp_path):
    """tests/test_ceph_volume.py's script on both packages; paths, the
    prepared OSDs' fsids and inventory's bytes used masked (the port's
    store pickles name ceph_tpu_torch classes, six bytes longer each)."""
    def mask(text, base):
        text = text.replace(base, "BASE")
        text = re.sub(r'"bytes_used": \d+', '"bytes_used": N', text)
        return re.sub(r"\b[0-9a-f]{32}\b", "FSID", text)

    outs = {}
    for prefix in (REF, PORT):
        T = tools(prefix)
        base = str(tmp_path / prefix)
        os.makedirs(base)
        script = []
        for argv in (["prepare", "--base", base, "--osd-id", "0"],
                     ["prepare", "--base", base, "--osd-id", "1"],
                     ["prepare", "--base", base, "--osd-id", "0"],
                     ["list", "--base", base]):
            rc, out = captured(T.ceph_volume.main, argv)
            script.append((rc, mask(out, base)))
        bs = T.BlueStore(os.path.join(base, "osd.0"), {})
        t = T.store.Transaction()
        t.write((1, "o", 0), b"adopted", T.store.ShardMeta())
        bs.queue_transaction(t)
        bs.close()
        bs = T.BlueStore(os.path.join(base, "osd.0"), {})
        assert bs.read((1, "o", 0))[0] == b"adopted"
        bs.close()
        os.makedirs(os.path.join(base, "spare"))
        for argv in (["inventory", "--base", base],
                     ["zap", "--base", base, "--osd-id", "1"],
                     ["zap", "--base", base, "--osd-id", "1", "--yes"],
                     ["list", "--base", base]):
            rc, out = captured(T.ceph_volume.main, argv)
            script.append((rc, mask(out, base)))
        assert not os.path.exists(os.path.join(base, "osd.1"))
        outs[prefix] = script
    assert outs[PORT] == outs[REF]
    assert [rc for rc, _ in outs[PORT]] == [0, 0, 1, 0, 0, 1, 0, 0]


# -- cephadm and vstart ----------------------------------------------------------


def test_cephadm_bootstrap_ls_stop_rm_and_orch_apply(tmp_path):
    """tests/test_tools.py's TestCephadmDeploy on the port, with --device
    cpu: the daemon host is `python -m ceph_tpu_torch.rados.vstart
    --device cpu`, reached by the port's ceph CLI from another process."""
    cephadm = tools(PORT).cephadm
    root = str(tmp_path / "clusters")

    def adm(*argv):
        return captured(cephadm.main, ["--data-root", root, *argv])

    rc, _ = adm("bootstrap", "--name", "c1", "--osds", "2",
                "--device", "cpu")
    assert rc == 0
    spec = json.load(open(f"{root}/c1/cluster.json"))
    try:
        assert spec["osds"] == 2 and spec["pid"] > 0
        with open(f"/proc/{spec['pid']}/cmdline", "rb") as f:
            cmdline = f.read().split(b"\0")
        assert b"ceph_tpu_torch.rados.vstart" in cmdline
        assert cmdline[cmdline.index(b"--device") + 1] == b"cpu"
        rc, out = adm("ls", "--format", "json")
        assert rc == 0 and [r["name"] for r in json.loads(out)] == ["c1"]
        mon = f"{spec['mons'][0][0]}:{spec['mons'][0][1]}"
        st = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.ceph", "--mon", mon,
             "--format", "json", "status"],
            capture_output=True, text=True, timeout=120, cwd=REPO)
        assert st.returncode == 0, st.stderr[-300:]
        assert json.loads(st.stdout)["osdmap"]["num_up_osds"] == 2
        assert adm("orch-apply", "--name", "c1", "--osds", "3")[0] == 0

        def published_osds():
            try:
                return json.load(open(f"{root}/c1/mons.json"))["osds"]
            except (OSError, ValueError):
                return -1

        deadline = time.monotonic() + 60
        while published_osds() != 3 and time.monotonic() < deadline:
            time.sleep(0.2)
        assert published_osds() == 3
        rc, out = adm("orch-ps", "--name", "c1", "--format", "json")
        assert rc == 0
        assert sum(1 for r in json.loads(out) if r["daemon"] == "osd"
                   and r["status"] == "running") == 3
        assert adm("bootstrap", "--name", "c1", "--device", "cpu")[0] == 1
        assert adm("stop", "--name", "c1")[0] == 0
        deadline = time.monotonic() + 5
        while cephadm._alive(spec["pid"]) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not cephadm._alive(spec["pid"])
        assert (tmp_path / "clusters" / "c1" / "data").is_dir()
        assert adm("rm-cluster", "--name", "c1")[0] == 1
        assert adm("rm-cluster", "--name", "c1", "--force")[0] == 0
        assert not (tmp_path / "clusters" / "c1").exists()
    finally:
        if cephadm._alive(spec["pid"]):
            os.kill(spec["pid"], 9)


def test_cephadm_bootstrap_defaults_to_the_card():
    args = tools(PORT).cephadm.parse_args(["bootstrap", "--name", "c"])
    assert args.device == "cuda"


@pytest.mark.parametrize("device", ["cpu", None])
def test_vstart_device_flag(device):
    """`python -m ceph_tpu_torch.rados.vstart --device cpu` starts a
    cluster; with no flag it asks for the card and, on a host without one,
    exits non-zero naming it."""
    argv = [sys.executable, "-m", "ceph_tpu_torch.rados.vstart", "--osds",
            "2", "--run-for", "0.5"]
    if device is None:
        if torch.cuda.is_available():
            pytest.skip("this host has a card")
    else:
        argv += ["--device", device]
    proc = subprocess.run(argv, capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    if device is None:
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
    else:
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert "2 OSDs up" in proc.stdout
