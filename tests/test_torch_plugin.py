"""plugin=cuda (ceph_tpu_torch) at codec level, on the CPU: byte identity
with ceph_tpu's plugin=tpu and plugin=jerasure, decode through the port's
seams, the port's matrices against the reference's, the archived plugin=tpu
corpus replayed under plugin=cuda, the benchmark CLI, and the seams' error
and counter semantics.  Exact equality throughout."""

import errno
import os
import re

import numpy as np
import pytest

from ceph_tpu.ec import matrices as ref_matrices
from ceph_tpu_torch.ec import matrices as port_matrices
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.plugins import cuda as cuda_plugin
from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF, CudaPlugin
from ceph_tpu_torch.ec.plugins.jerasure import JerasurePlugin
from ceph_tpu_torch.ec.registry import registry as port_registry
from ceph_tpu_torch.tools import benchmark
from tests.test_codecs import make, payload, roundtrip_exhaustive

CORPUS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "corpus",
                      "plugin=tpu stripe-width=4096 k=8 m=3")


@pytest.fixture(autouse=True)
def pinned_backend(monkeypatch):
    """Pin ceph_tpu's backend probe to a live verdict so plugin=tpu runs its
    device seam here (as tests/test_tpu.py does) rather than its fallback."""
    from ceph_tpu.utils import jaxdev

    verdict = jaxdev._result if jaxdev._result not in (None, jaxdev.UNAVAILABLE) else "cpu"
    monkeypatch.setattr(jaxdev, "_result", verdict)


def port(plugin_cls=CudaPlugin, **profile):
    profile = {k: str(v) for k, v in profile.items()}
    profile["plugin"] = "cuda" if plugin_cls is CudaPlugin else "jerasure"
    if plugin_cls is CudaPlugin:
        return CudaPlugin().factory(profile, device="cpu")
    return plugin_cls().factory(profile)


PROFILES = [
    dict(technique="reed_sol_van", k=2, m=2),
    dict(technique="reed_sol_van", k=4, m=2),
    dict(technique="reed_sol_van", k=8, m=3),
    dict(technique="reed_sol_van", k=3, m=2, w=16),
    dict(technique="reed_sol_van", k=4, m=2, w=4),
    dict(technique="reed_sol_r6_op", k=4),
    dict(technique="cauchy_orig", k=3, m=2, packetsize=8),
    dict(technique="cauchy_good", k=4, m=2, packetsize=8),
]


@pytest.mark.parametrize("profile", PROFILES)
def test_cuda_plugin_byte_identical_to_tpu_and_jerasure(profile):
    c = port(**profile)
    assert c.device.type == "cpu"
    data = payload(1 << 14, seed=42)
    n = c.get_chunk_count()
    before = PLUGIN_PERF.get("cpu_fallback")
    ec = c.encode(set(range(n)), data)
    assert PLUGIN_PERF.get("cpu_fallback") > before, "seam not exercised"
    for other in (make("tpu", **profile), make("jerasure", **profile),
                  port(JerasurePlugin, **profile)):
        eo = other.encode(set(range(n)), data)
        for i in range(n):
            assert np.array_equal(ec[i], eo[i]), f"chunk {i} vs {other}"


def test_cuda_plugin_exhaustive_decode():
    roundtrip_exhaustive(port(technique="reed_sol_van", k=4, m=2),
                         payload(1 << 12))
    roundtrip_exhaustive(
        port(technique="cauchy_good", k=4, m=2, packetsize=8), payload(1 << 12))


def test_cuda_plugin_three_erasure_decode():
    codec = port(technique="reed_sol_van", k=8, m=3)
    data = payload(1 << 16, seed=9)
    enc = codec.encode(set(range(11)), data)
    avail = {c: enc[c] for c in range(11) if c not in (0, 4, 10)}
    out = codec.decode({0, 4, 10}, avail, len(enc[0]))
    for c in (0, 4, 10):
        assert np.array_equal(out[c], enc[c])


@pytest.mark.parametrize("technique", ["liberation", "blaum_roth", "liber8tion"])
def test_cuda_plugin_bitmatrix_codes_match_tpu(technique):
    c = port(technique=technique, k=4, packetsize=8)
    t = make("tpu", technique=technique, k=4, packetsize=8)
    data = payload(5000, seed=7)
    ec, et = c.encode(set(range(6)), data), t.encode(set(range(6)), data)
    for i in range(6):
        assert np.array_equal(ec[i], et[i])
    out = c.decode({1, 4}, {i: ec[i] for i in (0, 2, 3, 5)}, len(ec[0]))
    assert np.array_equal(out[1], ec[1]) and np.array_equal(out[4], ec[4])


def test_matrices_equal_the_reference():
    for w in (4, 8, 16):
        for k, m in ((2, 1), (4, 2), (8, 3)):
            for fn in ("vandermonde_coding_matrix", "cauchy_orig_matrix",
                       "cauchy_good_matrix"):
                a = getattr(port_matrices, fn)(k, m, w)
                assert np.array_equal(a, getattr(ref_matrices, fn)(k, m, w))
                assert np.array_equal(port_matrices.matrix_to_bitmatrix(a, w),
                                      ref_matrices.matrix_to_bitmatrix(a, w))
        assert np.array_equal(port_matrices.r6_coding_matrix(5, w),
                              ref_matrices.r6_coding_matrix(5, w))
    for k, w in ((4, 7), (5, 11)):
        assert np.array_equal(port_matrices.liberation_bitmatrix(k, w),
                              ref_matrices.liberation_bitmatrix(k, w))
    assert np.array_equal(port_matrices.blaum_roth_bitmatrix(4, 6),
                          ref_matrices.blaum_roth_bitmatrix(4, 6))
    assert np.array_equal(port_matrices.liber8tion_bitmatrix(5),
                          ref_matrices.liber8tion_bitmatrix(5))
    bm = ref_matrices.matrix_to_bitmatrix(
        ref_matrices.vandermonde_coding_matrix(4, 4, 8), 8)
    sub = np.vstack([np.eye(32, dtype=np.uint8), bm])[8:40]
    assert np.array_equal(port_matrices.invert_bitmatrix(sub),
                          ref_matrices.invert_bitmatrix(sub))


def test_corpus_replays_under_cuda_plugin():
    """Chunks archived by plugin=tpu re-encode byte-identically, and 1- and
    2-erasure decodes return the archived chunks."""
    codec = port(technique="reed_sol_van", k=8, m=3)
    with open(os.path.join(CORPUS, "content"), "rb") as f:
        content = f.read()
    archived = {}
    for c in range(11):
        with open(os.path.join(CORPUS, str(c)), "rb") as f:
            archived[c] = np.frombuffer(f.read(), dtype=np.uint8)
    encoded = codec.encode(set(range(11)), content)
    for c in range(11):
        assert np.array_equal(encoded[c], archived[c]), f"chunk {c}"
    for erasures in ({0}, {0, 10}, {3, 8}):
        avail = {c: b for c, b in archived.items() if c not in erasures}
        out = codec.decode(erasures, avail, len(archived[0]))
        for c in erasures:
            assert np.array_equal(out[c], archived[c])


LINE = re.compile(r"^\d+\.\d{6}\t\d+$")


@pytest.mark.parametrize("argv,iterations", [
    (["--workload", "encode", "--iterations", "3"], 3),
    (["--workload", "decode", "--erasures", "3", "--iterations", "4"], 4),
    (["--workload", "decode", "--erased", "1", "--erased", "9"], 1),
    (["--workload", "decode", "-E", "exhaustive", "--erasures", "2"], 1),
])
def test_benchmark_cli_on_cpu(argv, iterations, capsys):
    base = ["--plugin", "cuda", "--device", "cpu", "-P", "technique=reed_sol_van",
            "-P", "k=8", "-P", "m=3", "--size", "65536"]
    assert benchmark.main(base + argv) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and LINE.match(out[0]), out
    assert out[0].split("\t")[1] == str(iterations * 64)


def test_benchmark_cli_perf_dump_and_factory_failure(capsys):
    argv = ["--plugin", "cuda", "--device", "cpu", "-P", "technique=cauchy_good",
            "-P", "k=4", "-P", "m=2", "-P", "packetsize=8", "--size", "8192",
            "--perf-dump"]
    assert benchmark.main(argv) == 0
    captured = capsys.readouterr()
    assert LINE.match(captured.out.strip())
    assert '"ec_plugin"' in captured.err and '"cpu_fallback"' in captured.err
    assert benchmark.main(["--plugin", "cuda", "--device", "tpu"]) == 1
    assert "factory(cuda) failed" in capsys.readouterr().err


def test_registry_resolves_cuda_plugin_on_its_default_device(monkeypatch):
    """plugin=cuda through the port's singleton builds on CUDA by default:
    with no card that is -ENODEV, never a quiet CPU codec."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(ErasureCodeError) as ei:
        port_registry.factory("cuda", "", {"plugin": "cuda", "k": "4", "m": "2"})
    assert ei.value.errno_code == -errno.ENODEV
    with pytest.raises(ErasureCodeError) as ei:
        CudaPlugin().factory({"technique": "nope"}, device="cpu")
    assert ei.value.errno_code == -errno.ENOENT


@pytest.mark.parametrize("packedbit,entry", [
    ("1", "gf2_apply_packedbit"),
    ("0", "gf2_apply_bytes"),
])
def test_dispatch_error_raises_eio_and_counts(monkeypatch, packedbit, entry):
    """A failing dispatch reaches the caller as -EIO with its cause; nothing
    falls back to another path.  On either w=8 lane: the packed-bit entry
    with the switch on (the default), gf2_apply_bytes with it off."""
    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", packedbit)
    codec = port(technique="reed_sol_van", k=4, m=2)

    def boom(*a, **kw):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(cuda_plugin, entry, boom)
    before = PLUGIN_PERF.get("device_failed")
    with pytest.raises(ErasureCodeError) as ei:
        codec.encode(set(range(6)), payload(4096))
    assert ei.value.errno_code == -errno.EIO
    assert "injected dispatch failure" in str(ei.value)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert PLUGIN_PERF.get("device_failed") == before + 1
