"""The port's native GF(2^8) core (ceph_tpu_torch/native) against ceph_tpu's.

The port builds its own copy of the reference's native sources with g++ at
first use.  Here its bridge is held byte for byte against the port's numpy
oracle, ceph_tpu's numpy oracle and ceph_tpu.native.bridge: gf_mul, gf_apply
on random matrices, rs_encode per technique against the port's codecs,
rs_decode, rs_encode_mt over awkward column splits, the scalar escape hatch,
the dlopen plugin registry's version handshake and the benchmark CLI (as
tests/test_native.py drives the reference's).  Then the seam: a port codec's
w=8 _apply goes through the native core, and a failed build raises.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from ceph_tpu.ec.gf import gf as ref_gf
from ceph_tpu.native import bridge as ref_bridge
from ceph_tpu_torch.ec import codecs
from ceph_tpu_torch.ec.gf import gf
from ceph_tpu_torch.ec.registry import registry
from ceph_tpu_torch.native import bridge

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tools():
    """The plugins and the benchmark CLI, built into one directory."""
    return bridge.build_tools()


def test_gf_mul_matches_both_oracles():
    rng = np.random.default_rng(0)
    for a, b in rng.integers(0, 256, size=(256, 2)):
        a, b = int(a), int(b)
        assert bridge.gf_mul(a, b) == gf(8).mul(a, b) == ref_gf(8).mul(a, b)
    assert bridge.gf_mul(0x80, 2) == ref_bridge.gf_mul(0x80, 2) == 0x1D


@pytest.mark.parametrize("rows,cols,chunk", [(3, 8, 4096), (1, 1, 1),
                                             (8, 3, 65 + 4096), (16, 11, 31)])
def test_gf_apply_random_matrices(rows, cols, chunk):
    rng = np.random.default_rng(rows * 100 + cols)
    matrix = rng.integers(0, 256, (rows, cols), dtype=np.uint8)
    data = rng.integers(0, 256, (cols, chunk), dtype=np.uint8)
    got = bridge.gf_apply(matrix, data)
    assert np.array_equal(got, gf(8).matmul(matrix, data))
    assert np.array_equal(got, ref_bridge.gf_apply(matrix, data))


@pytest.mark.parametrize("technique,plugin,pytech,k,m", [
    ("reed_sol_van", "jerasure", "reed_sol_van", 8, 3),
    ("reed_sol_van", "jerasure", "reed_sol_van", 4, 2),
    ("reed_sol_r6_op", "jerasure", "reed_sol_r6_op", 6, 2),
    ("isa_reed_sol_van", "isa", "reed_sol_van", 8, 3),
    ("isa_cauchy", "isa", "cauchy", 5, 3),
])
def test_rs_encode_per_technique(technique, plugin, pytech, k, m):
    codec = registry.factory(plugin, "", {"plugin": plugin,
                                          "technique": pytech,
                                          "k": str(k), "m": str(m)})
    data = np.random.default_rng(1).integers(0, 256, (k, 4096), dtype=np.uint8)
    got = bridge.rs_encode(technique, data, m)
    assert np.array_equal(got, codec.encode_chunks(data))
    assert np.array_equal(got, ref_bridge.rs_encode(technique, data, m))


def test_rs_encode_refuses_an_unknown_technique():
    with pytest.raises(RuntimeError, match="native encode failed"):
        bridge.rs_encode("nope", np.zeros((2, 8), dtype=np.uint8), 1)


def test_rs_decode_matches_reference():
    k, m = 8, 3
    data = np.random.default_rng(2).integers(0, 256, (k, 2048), dtype=np.uint8)
    full = np.vstack([data, bridge.rs_encode("reed_sol_van", data, m)])
    for erased in ([0, 4, 10], [1], [8, 9]):
        sources = [i for i in range(k + m) if i not in erased][:k]
        got = bridge.rs_decode("reed_sol_van", k, m, sources, full[sources],
                               erased)
        assert np.array_equal(got, full[erased])
        assert np.array_equal(got, ref_bridge.rs_decode(
            "reed_sol_van", k, m, sources, full[sources], erased))


def test_rs_encode_mt_equals_one_thread():
    rng = np.random.default_rng(3)
    for chunk in (1 << 20, 4096, 4097, 64, 63, 130):
        data = rng.integers(0, 256, (8, chunk), dtype=np.uint8)
        one = bridge.rs_encode("reed_sol_van", data, 3)
        for nthreads in (0, 1, 3, 7):
            got, used = bridge.rs_encode_mt("reed_sol_van", data, 3, nthreads)
            assert used >= 1
            assert np.array_equal(got, one), (chunk, nthreads)


def test_scalar_escape_hatch_gives_the_same_bytes():
    assert bridge.simd_kind() == ref_bridge.simd_kind()
    assert bridge.simd_kind() in ("gfni", "avx2", "scalar")
    code = ("import sys, numpy as np; from ceph_tpu_torch.native import bridge;"
            "d = np.arange(8 * 1000, dtype=np.uint8).reshape(8, 1000);"
            "print(bridge.simd_kind());"
            "sys.stdout.flush();"
            "sys.stdout.buffer.write(bridge.rs_encode('reed_sol_van', d, 3)"
            ".tobytes())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, CEPH_TPU_NO_SIMD="1",
                                  PYTHONPATH=ROOT),
                         capture_output=True, timeout=120, check=True)
    kind, parity = out.stdout.split(b"\n", 1)
    assert kind.strip() == b"scalar"
    d = np.arange(8 * 1000, dtype=np.uint8).reshape(8, 1000)
    assert parity == bridge.rs_encode("reed_sol_van", d, 3).tobytes()


@pytest.mark.parametrize("workload", ["encode", "decode"])
def test_native_benchmark_cli(tools, workload):
    """The reference protocol: '<seconds>\\t<KB>' on stdout."""
    out = subprocess.run(
        [os.path.join(tools, bridge.BENCHMARK), "--plugin", "isa",
         "--workload", workload, "--iterations", "4", "--size", "1048576",
         "-P", "k=8", "-P", "m=3", "-P", "technique=reed_sol_van",
         "--directory", tools],
        capture_output=True, text=True, check=True, timeout=120)
    seconds, kb = out.stdout.strip().split("\t")
    assert float(seconds) > 0 and kb == "4096"


def test_native_registry_refuses_unknown_and_mismatched_plugins(tools,
                                                                tmp_path):
    bench = os.path.join(tools, bridge.BENCHMARK)
    r = subprocess.run([bench, "--plugin", "doesnotexist", "--directory",
                        tools], capture_output=True, text=True, timeout=60)
    assert r.returncode != 0 and "failed" in r.stderr
    src = tmp_path / "bad.cc"
    src.write_text('extern "C" {\n'
                   'const char* __erasure_code_version() { return "9.9.9"; }\n'
                   'int __erasure_code_init(const char*, void*) { return 0; }\n'
                   '}\n')
    subprocess.run(["g++", "-std=c++17", "-fPIC", "-shared", "-o",
                    str(tmp_path / "libec_badversion.so"), str(src)],
                   check=True, capture_output=True, timeout=120)
    r = subprocess.run([bench, "--plugin", "badversion", "--directory",
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode != 0 and "-18" in r.stderr  # -EXDEV


def test_w8_apply_goes_through_the_native_core(monkeypatch):
    calls = []
    real = codecs._native_gf_apply

    def counted():
        fn = real()

        def apply(matrix, regions):
            calls.append(regions.shape)
            return fn(matrix, regions)

        return apply

    monkeypatch.setattr(codecs, "_native_gf_apply", counted)
    codec = registry.factory("jerasure", "", {"plugin": "jerasure",
                                              "technique": "reed_sol_van",
                                              "k": "4", "m": "2"})
    data = np.random.default_rng(4).integers(0, 256, 8192,
                                             dtype=np.uint8).tobytes()
    encoded = codec.encode(set(range(6)), data)
    out = codec.decode({0, 5}, {c: encoded[c] for c in (1, 2, 3, 4)},
                       len(encoded[0]))
    assert np.array_equal(out[0], encoded[0])
    assert len(calls) >= 2  # the encode and the decode
    wide = registry.factory("jerasure", "", {"plugin": "jerasure",
                                             "technique": "reed_sol_van",
                                             "k": "3", "m": "2", "w": "16"})
    before = len(calls)
    wide.encode(set(range(5)), data)
    assert len(calls) == before  # w=16 stays on the numpy oracle


def test_a_failed_build_raises_with_the_compiler_message(tmp_path,
                                                         monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(bridge.CSRC, csrc)
    first = bridge.LIB_SOURCES[0]  # g++ stops at the first source
    with open(csrc / first, "a") as f:
        f.write("\nint broken_on_purpose( {\n")
    monkeypatch.setattr(bridge, "CSRC", str(csrc))
    monkeypatch.setattr(bridge, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(bridge, "_LIB", None)
    codec = registry.factory("isa", "", {"plugin": "isa", "k": "4", "m": "2"})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        codec.encode(set(range(6)), b"x" * 4096)
    assert first in str(e.value)
    assert not os.listdir(tmp_path / "build")  # no partial library left
