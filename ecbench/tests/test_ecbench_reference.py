"""The plain reference against jerasure: a corpus archive made by the
upstream tool, and the port's CPU codecs at the configurations' profiles."""

import os

import numpy as np
import pytest

from ecbench import spec
from ecbench.tests.helpers import ROOT

ref = spec.load_module("references", "jerasure")


def test_reed_sol_van_matches_the_jerasure_corpus():
    d = os.path.join(ROOT, "corpus",
                     "plugin=jerasure stripe-width=4096 technique=reed_sol_van"
                     " k=4 m=2")
    content = open(os.path.join(d, "content"), "rb").read()
    chunks = ref.Code({"technique": "reed_sol_van", "k": "4",
                       "m": "2"}).encode(content)
    for i in range(6):
        assert chunks[i].tobytes() == open(os.path.join(d, str(i)),
                                           "rb").read()


@pytest.mark.parametrize("k, m", [(8, 3), (4, 2), (10, 4)])
def test_matrices_equal_the_port(k, m):
    from ceph_tpu_torch.ec import matrices as M

    f = ref.Field()
    assert (ref.vandermonde_coding_matrix(f, k, m)
            == M.vandermonde_coding_matrix(k, m, 8)).all()
    if m > 2:
        good = ref.cauchy_good_matrix(f, k, m)
        assert (good == M.cauchy_good_matrix(k, m, 8)).all()
        assert (ref.bitmatrix(f, good)
                == M.matrix_to_bitmatrix(M.cauchy_good_matrix(k, m, 8),
                                         8)).all()


@pytest.mark.parametrize("config, size", [("rs-k8m3", 1 << 20 | 12345),
                                          ("cauchy-k10m4", 700000)])
def test_encode_equals_the_port_on_the_cpu(config, size):
    import json

    from ceph_tpu_torch.ec.registry import registry

    cfg = json.load(open(os.path.join(ROOT, "ecbench", "configs",
                                      f"{config}.json")))
    codec = registry.factory("jerasure", "", dict(cfg["profile"],
                                                  plugin="jerasure"))
    obj = np.random.default_rng(5).bytes(size)
    want = set(range(codec.get_chunk_count()))
    got = codec.encode(want, obj)
    expect = ref.Code(cfg["profile"]).encode(obj)
    assert len(got) == len(expect)
    for c in want:
        assert (np.asarray(got[c]) == expect[c]).all(), c


def test_another_polynomial_changes_the_chunks():
    obj = np.random.default_rng(1).bytes(1 << 16)
    prof = {"technique": "reed_sol_van", "k": "8", "m": "3"}
    a = ref.Code(prof).encode(obj)
    b = ref.Code(prof, poly=0x12B).encode(obj)
    # data and the first parity chunk (jerasure's all-ones row: the XOR)
    # agree in every field; the other parity chunks do not
    assert (a[:9] == b[:9]).all() and (a[9:] != b[9:]).mean() > 0.9
    with pytest.raises(ValueError):
        ref.Field(0x11B)  # irreducible, not primitive
