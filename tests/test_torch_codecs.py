"""The port's CPU codec plugins (isa, shec, lrc, clay, xor) against ceph_tpu's.

The same profiles and seeded payloads go through ceph_tpu's registry and the
port's.  The codes are exact over GF(2^8), so every comparison is byte for
byte: completed profiles, chunks, every decode over the erasure sets that
tests/test_lrc.py, test_shec.py and test_clay.py use, minimum_to_decode plans
(clay's sub-chunk runs included) and clay's repair reads.  The EINVAL
profiles of those tests fail the same way on both.  The archived isa, shec
and jerasure corpus directories replay through the port, and lrc with
plugin=cuda layers and clay with scalar_mds=cuda, both built on the CPU,
equal their jerasure-layered twins.
"""

import errno
import itertools
import json
import os

import numpy as np
import pytest

from ceph_tpu.ec.interface import ErasureCodeError as RefError
from ceph_tpu.ec.registry import registry as ref_registry
from ceph_tpu_torch.ec.interface import ErasureCodeError
from ceph_tpu_torch.ec.registry import registry

CORPUS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "corpus")


def profile_of(plugin, **params):
    return {"plugin": plugin, **{k: str(v) for k, v in params.items()}}


def pair(plugin, **params):
    """(ceph_tpu's codec, the port's codec) for one profile."""
    profile = profile_of(plugin, **params)
    ref = ref_registry.factory(plugin, "", dict(profile))
    port = registry.factory(plugin, "", dict(profile))
    assert port.get_profile() == ref.get_profile()
    return ref, port


def payload(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def encode_both(ref, port, data):
    n = ref.get_chunk_count()
    assert port.get_chunk_count() == n
    assert port.get_chunk_size(len(data)) == ref.get_chunk_size(len(data))
    want = ref.encode(set(range(n)), data)
    got = port.encode(set(range(n)), data)
    assert sorted(got) == sorted(want)
    for c in want:
        assert np.array_equal(got[c], want[c]), f"chunk {c}"
    return want


def decode_both(ref, port, encoded, erasure_sets):
    """Each erasure set: the same plan and the same (right) chunks."""
    n = len(encoded)
    chunk_size = len(encoded[0])
    for erased in erasure_sets:
        avail = {c: encoded[c] for c in range(n) if c not in erased}
        assert port.minimum_to_decode(set(erased), set(avail)) == \
            ref.minimum_to_decode(set(erased), set(avail)), erased
        got = port.decode(set(erased), avail, chunk_size)
        for c in erased:
            assert np.array_equal(got[c], encoded[c]), (erased, c)


def sets_up_to(n, r):
    return [s for i in range(1, r + 1) for s in itertools.combinations(range(n), i)]


def assert_same_refusal(plugin, **params):
    profile = profile_of(plugin, **params)
    with pytest.raises(RefError) as want:
        ref_registry.factory(plugin, "", dict(profile))
    with pytest.raises(ErasureCodeError) as got:
        registry.factory(plugin, "", dict(profile))
    assert got.value.errno_code == want.value.errno_code, profile


# ------------------------------------------------------------------ isa --

@pytest.mark.parametrize("params", [
    dict(technique="reed_sol_van", k=8, m=3),
    dict(technique="reed_sol_van", k=4, m=2),
    dict(technique="cauchy", k=5, m=3),
    dict(k=7, m=3),
])
def test_isa_equals_reference(params):
    ref, port = pair("isa", **params)
    encoded = encode_both(ref, port, payload(10_000, seed=1))
    m = ref.get_coding_chunk_count()
    decode_both(ref, port, encoded, sets_up_to(len(encoded), min(m, 3)))


@pytest.mark.parametrize("params", [
    dict(k=0, m=3), dict(k=8, m=0), dict(technique="nope", k=4, m=2),
    dict(k=32, m=32),
])
def test_isa_refuses_what_the_reference_refuses(params):
    assert_same_refusal("isa", **params)


# ----------------------------------------------------------------- shec --

SHEC_GRID = [(4, 3, 2), (4, 2, 1), (6, 3, 2), (8, 4, 3), (5, 5, 2),
             (10, 4, 2), (12, 6, 3)]


@pytest.mark.parametrize("k,m,c", SHEC_GRID)
def test_shec_equals_reference(k, m, c):
    ref, port = pair("shec", k=k, m=m, c=c)
    assert np.array_equal(port.matrix, ref.matrix)
    encoded = encode_both(ref, port, payload(1 << 12, seed=k * 100 + m * 10 + c))
    decode_both(ref, port, encoded,
                list(itertools.combinations(range(k + m), c)))


def test_shec_plans_with_cost_and_techniques():
    ref, port = pair("shec", k=8, m=4, c=3)
    for lost in range(12):
        avail = set(range(12)) - {lost}
        assert port.minimum_to_decode({lost}, avail) == \
            ref.minimum_to_decode({lost}, avail)
        costs = {i: 1 + i % 3 for i in avail}
        assert port.minimum_to_decode_with_cost({lost}, costs) == \
            ref.minimum_to_decode_with_cost({lost}, costs)
    with pytest.raises(ErasureCodeError) as e:
        port.minimum_to_decode(set(range(5)), set(range(5, 12)))
    assert e.value.errno_code == -errno.EIO
    for technique in ("single", "multiple"):
        ref, port = pair("shec", k=6, m=3, c=2, technique=technique)
        assert np.array_equal(port.matrix, ref.matrix)
    ref, port = pair("shec")  # defaults (4, 3, 2)
    assert port.get_chunk_count() == 7


@pytest.mark.parametrize("params", [
    dict(k=13, m=3, c=2), dict(k=12, m=12, c=2), dict(k=4, m=5, c=2),
    dict(k=4, m=3, c=4), dict(k=4, m=3, c=0), dict(k=4, m=3),
])
def test_shec_refuses_what_the_reference_refuses(params):
    assert_same_refusal("shec", **params)


# ------------------------------------------------------------------ lrc --

EXPLICIT_LAYERS = json.dumps([
    ["DDc_DDc_", ""],
    ["DDDc____", {"plugin": "jerasure", "technique": "reed_sol_van"}],
    ["____DDDc", "plugin=jerasure technique=reed_sol_van"],
])


@pytest.mark.parametrize("params", [
    dict(k=4, m=2, l=3),
    dict(mapping="DD__DD__", layers=EXPLICIT_LAYERS),
    dict(k=8, m=4, l=6),
])
def test_lrc_equals_reference(params):
    ref, port = pair("lrc", **params)
    encoded = encode_both(ref, port, payload(100_000, seed=9))
    decode_both(ref, port, encoded, sets_up_to(len(encoded), 2))
    n = len(encoded)
    for lost in range(n):  # the locality plans
        avail = set(range(n)) - {lost}
        assert port.minimum_to_decode({lost}, avail) == \
            ref.minimum_to_decode({lost}, avail)
    avail = {c: encoded[c] for c in range(n) if c not in (0, 4)}
    assert port.decode_concat(avail) == ref.decode_concat(avail)


def test_lrc_layer_of_the_xor_plugin():
    layers = json.dumps([["DDc", {"plugin": "xor", "k": "2"}]])
    ref, port = pair("lrc", mapping="DD_", layers=layers)
    encoded = encode_both(ref, port, payload(4096, seed=3))
    decode_both(ref, port, encoded, [(0,), (1,), (2,)])


def test_lrc_unrecoverable_is_eio_on_both():
    ref, port = pair("lrc", k=4, m=2, l=3)
    for codec, err in ((ref, RefError), (port, ErasureCodeError)):
        with pytest.raises(err) as e:
            codec.minimum_to_decode({0}, set(range(4, 8)))
        assert e.value.errno_code == -errno.EIO


@pytest.mark.parametrize("params", [
    dict(k=4, m=2), dict(k=4, m=2, l=5), dict(k=3, m=3, l=3),
    dict(k=4, m=2, l=3, mapping="DDDD____"),
    dict(mapping="DD__", layers="not json"),
    dict(mapping="DD__", layers=json.dumps({"a": 1})),
    dict(mapping="DD__", layers=json.dumps([["DD__", 42]])),
    dict(mapping="DD__", layers=json.dumps([["DDc", ""]])),
    dict(layers=json.dumps([["DDc_", ""]])),
    dict(mapping="DD__", layers=json.dumps([["DDc_", ""]])),
    dict(mapping="DD__", layers=json.dumps([["DDcD", ""], ["__Dc", ""]])),
])
def test_lrc_refuses_what_the_reference_refuses(params):
    assert_same_refusal("lrc", **params)


# ----------------------------------------------------------------- clay --

@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (3, 2, 4), (4, 3, 5),
                                   (6, 3, 8), (8, 4, 11)])
def test_clay_equals_reference(k, m, d):
    ref, port = pair("clay", k=k, m=m, d=d)
    assert (port.q, port.t, port.nu, port.get_sub_chunk_count()) == \
        (ref.q, ref.t, ref.nu, ref.get_sub_chunk_count())
    data = payload(ref.get_chunk_size(1) * k, seed=k * 16 + m)
    encoded = encode_both(ref, port, data)
    decode_both(ref, port, encoded, sets_up_to(len(encoded), min(m, 2)))


@pytest.mark.parametrize("k,m,d", [(4, 2, 5), (3, 2, 4), (6, 3, 8),
                                   (8, 4, 11), (4, 3, 5), (6, 3, 7),
                                   (8, 4, 9)])
def test_clay_repair_reads_equal_reference(k, m, d):
    """Each lost chunk: the same sub-chunk plan, and the repair from the
    helpers' sub-chunk runs alone rebuilds it on both."""
    ref, port = pair("clay", k=k, m=m, d=d)
    n = ref.get_chunk_count()
    encoded = encode_both(ref, port, payload(ref.get_chunk_size(1) * k,
                                             seed=d))
    chunk_size = len(encoded[0])
    sc_size = chunk_size // ref.get_sub_chunk_count()
    for lost in range(n):
        plan = port.minimum_to_decode({lost}, set(range(n)) - {lost})
        assert plan == ref.minimum_to_decode({lost}, set(range(n)) - {lost})
        assert len(plan) == d
        helpers = {c: np.concatenate([encoded[c][o * sc_size:(o + cnt) * sc_size]
                                      for o, cnt in runs])
                   for c, runs in plan.items()}
        assert all(len(h) == chunk_size // port.q for h in helpers.values())
        out = port.decode({lost}, helpers, chunk_size)
        assert np.array_equal(out[lost], encoded[lost]), lost


def test_clay_with_isa_and_shec_inner_codecs():
    for scalar in ("isa", "shec"):
        ref, port = pair("clay", k=4, m=2, d=5, scalar_mds=scalar)
        encoded = encode_both(ref, port, payload(ref.get_chunk_size(1) * 4,
                                                 seed=7))
        decode_both(ref, port, encoded, [(2,), (0, 5)])


@pytest.mark.parametrize("params", [
    dict(k=4, m=2, d=3), dict(k=4, m=2, d=6), dict(k=4, m=2, scalar_mds="nope"),
    dict(k=4, m=2, scalar_mds="jerasure", technique="liberation"),
    dict(k=0, m=2),
])
def test_clay_refuses_what_the_reference_refuses(params):
    assert_same_refusal("clay", **params)


def test_clay_names_cuda_where_the_reference_names_tpu():
    with pytest.raises(ErasureCodeError, match="'cuda'") as e:
        registry.factory("clay", "", profile_of("clay", k=4, m=2,
                                                scalar_mds="tpu"))
    assert e.value.errno_code == -errno.EINVAL


# ------------------------------------------------------------------ xor --

@pytest.mark.parametrize("k", [2, 3, 5])
def test_xor_equals_reference(k):
    ref, port = pair("xor", k=k)
    encoded = encode_both(ref, port, payload(5000, seed=k))
    decode_both(ref, port, encoded, [(c,) for c in range(k + 1)])


# --------------------------------------------------- plugin=cuda inside --

def test_lrc_cuda_layers_equal_jerasure_layers():
    cuda_layers = json.dumps([[chunks, "plugin=cuda technique=reed_sol_van"]
                              for chunks in ("DDc_DDc_", "DDDc____", "____DDDc")])
    profile = profile_of("lrc", mapping="DD__DD__", layers=cuda_layers)
    on_cpu = registry.factory("lrc", "", dict(profile), device="cpu")
    for layer in on_cpu.layers:
        assert layer.erasure_code.plugin_name == "cuda"
        assert layer.erasure_code.device.type == "cpu"
    twin = registry.factory("lrc", "", profile_of(
        "lrc", mapping="DD__DD__", layers=EXPLICIT_LAYERS))
    data = payload(100_000, seed=21)
    want = twin.encode(set(range(8)), data)
    got = on_cpu.encode(set(range(8)), data)
    for c in range(8):
        assert np.array_equal(got[c], want[c]), c
    for erased in [(0,), (3,), (0, 4), (1, 6)]:
        avail = {c: want[c] for c in range(8) if c not in erased}
        out = on_cpu.decode(set(erased), avail, len(want[0]))
        for c in erased:
            assert np.array_equal(out[c], want[c]), (erased, c)


def test_clay_scalar_mds_cuda_equals_jerasure():
    params = dict(k=4, m=2, d=5)
    on_cpu = registry.factory("clay", "", profile_of(
        "clay", scalar_mds="cuda", **params), device="cpu")
    assert on_cpu.mds.device.type == on_cpu.pft.device.type == "cpu"
    twin = registry.factory("clay", "", profile_of(
        "clay", scalar_mds="jerasure", **params))
    data = payload(twin.get_chunk_size(1) * 4, seed=11)
    want = twin.encode(set(range(6)), data)
    got = on_cpu.encode(set(range(6)), data)
    for c in range(6):
        assert np.array_equal(got[c], want[c]), c
    plan = on_cpu.minimum_to_decode({1}, set(range(6)) - {1})
    sc = len(want[0]) // on_cpu.get_sub_chunk_count()
    helpers = {c: np.concatenate([want[c][o * sc:(o + n) * sc] for o, n in runs])
               for c, runs in plan.items()}
    assert np.array_equal(on_cpu.decode({1}, helpers, len(want[0]))[1], want[1])


def test_cuda_without_a_card_fails_inside_lrc(monkeypatch):
    """No device named and no card: the nested plugin=cuda factory refuses
    with -ENODEV, as a plain plugin=cuda profile does."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    layers = json.dumps([["DDc", "plugin=cuda"]])
    with pytest.raises(ErasureCodeError) as e:
        registry.factory("lrc", "", profile_of("lrc", mapping="DD_",
                                               layers=layers))
    assert e.value.errno_code == -errno.ENODEV


# --------------------------------------------------------------- corpus --

CORPUS_DIRS = sorted(d for d in os.listdir(CORPUS)
                     if d.startswith("plugin=") and not d.startswith("plugin=tpu"))


def test_corpus_has_isa_and_shec_archives():
    assert any(d.startswith("plugin=isa") for d in CORPUS_DIRS)
    assert any(d.startswith("plugin=shec") for d in CORPUS_DIRS)


@pytest.mark.parametrize("name", CORPUS_DIRS)
def test_corpus_replays_through_port(name):
    """Re-encode the archived content and decode one and two erasures, as
    ceph_tpu.tools.non_regression --check does."""
    parts = name.split()
    plugin = parts[0].split("=", 1)[1]
    profile = {"plugin": plugin, **dict(kv.split("=", 1) for kv in parts[2:])}
    codec = registry.factory(plugin, "", profile)
    directory = os.path.join(CORPUS, name)
    with open(os.path.join(directory, "content"), "rb") as f:
        content = f.read()
    n = codec.get_chunk_count()
    encoded = codec.encode(set(range(n)), content)
    for c in range(n):
        with open(os.path.join(directory, str(c)), "rb") as f:
            assert bytes(encoded[c]) == f.read(), f"chunk {c}"
    for erasures in ({0}, {0, n - 1}):
        avail = {c: encoded[c] for c in range(n) if c not in erasures}
        out = codec.decode(erasures, avail, len(encoded[0]))
        for c in erasures:
            assert np.array_equal(out[c], encoded[c]), (erasures, c)


# ------------------------------------------------------------ the CLI --

CLI_ARGS = ["--size", "65536", "--iterations", "2", "--device", "cpu"]


@pytest.mark.parametrize("argv", [
    ["--plugin", "isa", "-P", "k=8", "-P", "m=3"],
    ["--plugin", "shec", "-P", "k=4", "-P", "m=3", "-P", "c=2"],
    ["--plugin", "lrc", "-P", "k=4", "-P", "m=2", "-P", "l=3"],
    ["--plugin", "lrc", "-P", "mapping=DD__DD__", "-P",
     "layers=" + EXPLICIT_LAYERS.replace('"plugin": "jerasure", ', "")],
    ["--plugin", "clay", "-P", "k=4", "-P", "m=2", "-P", "scalar_mds=cuda"],
])
def test_benchmark_cli_runs_the_plugins(argv, capsys):
    """The port's CLI drives each plugin, -P mapping=/layers= reach lrc
    unchanged, and --device reaches the plugin=cuda codecs clay builds."""
    from ceph_tpu_torch.tools import benchmark

    for workload in (["--workload", "encode"],
                     ["--workload", "decode", "--erasures", "2"]):
        assert benchmark.main(argv + CLI_ARGS + workload) == 0
        seconds, kb = capsys.readouterr().out.strip().split("\t")
        assert float(seconds) > 0 and kb == "128"
    profile = {"plugin": argv[1], **dict(
        a.split("=", 1) for a in argv[3::2])}
    codec = benchmark.make_codec(benchmark.parse_args(argv + CLI_ARGS),
                                 profile)
    assert {k: codec.get_profile()[k] for k in profile} == profile
