"""The kernels' frozen byte counts at the cells' shapes."""

import numpy as np
import pytest

from ecbench import roofline, spec
from ecbench.tests.helpers import ROOT

RS = {"plugin": "cuda", "technique": "reed_sol_van", "k": "8", "m": "3",
      "w": "8"}
CAUCHY = {"plugin": "cuda", "technique": "cauchy_good", "k": "10", "m": "4",
          "w": "8", "packetsize": "2048"}
MIB4 = 4 << 20


def _plan(profile, mix):
    from ceph_tpu_torch.ec.registry import registry

    codec = registry.factory("cuda", "", profile, device="cpu")
    objects = [memoryview(bytes(MIB4))]
    kind = spec.load_module("kinds", mix["op"])
    if mix["op"] == "degraded_read":  # its set-up encodes: keep it cheap
        codec.encode = lambda want, data: {c: np.zeros(0) for c in want}
    return kind.Plan(codec, objects, {}, mix, np.random.default_rng(0))


@pytest.mark.parametrize("profile, mix, read, written", [
    (RS, {"op": "encode", "callers": 1}, 4194304, 1572864),
    (CAUCHY, {"op": "encode", "callers": 1}, 4587520, 1835008),
    (RS, {"op": "degraded_read", "callers": 1, "lost": 1}, 4194304, 524288),
])
def test_kernel_bytes_at_the_cells_shapes(profile, mix, read, written):
    plan = _plan(profile, mix)
    op = plan.callers[0][0]
    r, w = plan.kernel_chunks(op)
    assert (r * plan.chunk_size, w * plan.chunk_size) == (read, written)
    assert roofline.kernel_bytes(r, w, plan.chunk_size) == read + written


def test_k4_bound_at_the_encode_shape():
    peak = roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3")
    assert peak == 3.35e12
    assert (4194304 + 1572864) / peak * 1e6 == pytest.approx(1.7215, abs=1e-4)
    assert roofline.peak_bytes_per_s("cpu") is None
