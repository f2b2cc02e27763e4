"""The port's device mesh against ceph_tpu's.

The reference lays a batch over the conftest's 8-device virtual CPU mesh
(tests/test_mesh.py); the port lays it over its 8-shard mesh of the CPU,
named as the caller's device (``MeshDispatcher(["cpu"] * 8)``, what
``shared_mesh("cpu")`` builds under CEPH_TPU_MESH=1).  The axes and padding
equal the reference's for every grid of 2 to 8 devices; the same submissions
on all six lanes give the same bytes and the same sharded dispatch and
shard-put counts through both queues on their meshes; an unforced
single-device process and ``mesh=False`` have no mesh, and a forced mesh
that cannot be built raises.  Then tests/test_mesh.py's 3-OSD cluster with
concurrent puts on both packages: each coalesces, every dispatch rides the
mesh, and every get reads back the same.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from ceph_tpu.ec.matrices import matrix_to_bitmatrix, vandermonde_coding_matrix
from ceph_tpu.parallel import mesh as ref_mesh
from ceph_tpu.parallel import service as ref_service
from ceph_tpu_torch.parallel import mesh
from ceph_tpu_torch.parallel.mesh import MeshDispatcher
from ceph_tpu_torch.parallel.service import BatchingQueue

K, M = 4, 2
WIDTHS = (1000, 2048, 4096)  # byte columns of the three requests a lane gets
TIMEOUT = 120
PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van",
           "k": "2", "m": "1"}


def ref_devices(n: int):
    import jax

    pool = jax.devices("cpu")
    if len(pool) < n:
        pytest.skip("needs the 8-device virtual CPU mesh")
    return pool[:n]


@pytest.mark.parametrize("n", range(2, 9))
def test_axes_and_padding_equal_the_reference(n):
    ref = ref_mesh.MeshDispatcher(ref_devices(n))
    port = MeshDispatcher(["cpu"] * n)
    assert mesh._factor_axes(n) == ref_mesh._factor_axes(n)
    assert dict(zip(port.axis_names, port.mesh.shape)) == \
        dict(zip(ref.mesh.axis_names, ref.mesh.devices.shape))
    assert port.n_devices == ref.n_devices == n
    for cols in (1, 7, 1000, 1001, 4096, 4099):
        assert port.pad_cols(cols) == ref.pad_cols(cols)


def test_shard_batch_splits_columns_in_device_order():
    port = MeshDispatcher(["cpu"] * 8)
    batch = torch.arange(4 * 64, dtype=torch.int32).reshape(4, 64)
    shards = port.shard_batch(batch)
    assert port.shard_puts == 1
    assert [b for _, b in shards] == [(8 * i, 8 * i + 8) for i in range(8)]
    for part, (c0, c1) in shards:  # views of the one batch, no copies
        assert part.data_ptr() == batch[:, c0].data_ptr()
        assert torch.equal(part, batch[:, c0:c1])
    with pytest.raises(ValueError, match="do not split"):
        port.shard_batch(batch[:, :63])
    with pytest.raises(ValueError, match=">= 2 devices"):
        MeshDispatcher(["cpu"])


def test_no_mesh_unless_forced_or_several_cards(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_MESH", raising=False)
    monkeypatch.setattr(mesh, "_SHARED", {})
    assert mesh.shared_mesh("cpu") is None
    q = BatchingQueue(device="cpu")
    pinned = BatchingQueue(device="cpu", mesh=False)
    try:
        assert q.mesh is None and pinned.mesh is None
    finally:
        q.close()
        pinned.close()
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    forced = mesh.shared_mesh("cpu")
    assert forced.devices == [torch.device("cpu")] * mesh.FORCED_SHARDS
    assert mesh.shared_mesh("cpu") is forced  # one layout a process
    pinned = BatchingQueue(device="cpu", mesh=False)
    try:
        assert pinned.mesh is None
    finally:
        pinned.close()


def test_a_forced_mesh_that_cannot_be_built_raises(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    monkeypatch.setattr(mesh, "_SHARED", {})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for _ in range(2):  # a failure is not remembered as "no mesh"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.shared_mesh("cuda")
    assert mesh._SHARED == {}


def lane_inputs(kind: str, w: int, seed: int):
    """Three requests for `kind` as the reference takes them: packed uint8
    rows, int8 bit-planes (planar) or uint32 plane words
    (packedbit_planes); the packed-bit resident and plane lanes take whole
    words."""
    rng = np.random.default_rng(seed)
    widths = ((1024, 2048, 4096)
              if kind in ("packedbit_resident", "packedbit_planes")
              else WIDTHS)
    data = [rng.integers(0, 256, (K, B), dtype=np.uint8) for B in widths]
    if kind == "planar":
        return [ref_service._np_unpack_bits(d, w) for d in data]
    if kind == "packedbit_planes":
        return [ref_service._np_words(ref_service._np_unpack_bits(d, 8))
                for d in data]
    return data


def port_input(kind: str, x: np.ndarray):
    if kind == "planar":
        return torch.from_numpy(x)
    if kind == "packedbit_planes":
        return torch.from_numpy(x.view(np.int32))
    return x


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.numpy()
        return x.view(np.uint32) if x.dtype == np.int32 else x
    return np.asarray(x)


SUBMIT = {"packed": "submit", "planar": "submit_planar",
          "resident": "submit_resident", "packedbit": "submit_packedbit",
          "packedbit_resident": "submit_packedbit_resident",
          "packedbit_planes": "submit_packedbit_planes"}


@pytest.fixture(scope="module")
def queues_on_meshes():
    """The reference's queue on its 8-device mesh and the port's on its 8
    CPU shards; a flush() cuts each round, so that both see the same
    dispatches."""
    ref_m = ref_mesh.MeshDispatcher(ref_devices(8))
    port_m = MeshDispatcher(["cpu"] * 8)
    ref_q = ref_service.BatchingQueue(max_delay=600.0, mesh=ref_m)
    port_q = BatchingQueue(device="cpu", max_delay=600.0, mesh=port_m)
    yield ref_q, port_q
    ref_q.close()
    port_q.close()
    assert not port_q._worker.is_alive()


@pytest.mark.parametrize("kind,w", [
    ("packed", 8), ("packed", 16), ("planar", 8), ("resident", 8),
    ("resident", 16), ("packedbit", 8), ("packedbit_resident", 8),
    ("packedbit_planes", 8)])
def test_lane_on_mesh_matches_reference(kind, w, queues_on_meshes):
    ref_q, port_q = queues_on_meshes
    mb = matrix_to_bitmatrix(vandermonde_coding_matrix(K, M, w), w).astype(
        np.uint8 if kind.startswith("packedbit") else np.int8)
    inputs = lane_inputs(kind, w, seed=len(kind) * 100 + w)
    before = [(q.dispatches, q.sharded_dispatches, q.mesh.shard_puts)
              for q in (ref_q, port_q)]
    ref_futs = [getattr(ref_q, SUBMIT[kind])(mb, x, w, M) for x in inputs]
    port_futs = [getattr(port_q, SUBMIT[kind])(mb, port_input(kind, x), w, M)
                 for x in inputs]
    ref_q.flush()
    port_q.flush()
    for i, (rf, pf) in enumerate(zip(ref_futs, port_futs)):
        got, want = pf.result(timeout=TIMEOUT), rf.result(timeout=TIMEOUT)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, x in zip(got, want):
            g, x = as_np(g), as_np(x)
            assert g.dtype == x.dtype and g.shape == x.shape, (kind, i)
            assert np.array_equal(g, x), f"{kind} w={w} request {i} differs"
    after = [(q.dispatches, q.sharded_dispatches, q.mesh.shard_puts)
             for q in (ref_q, port_q)]
    moved = [tuple(a - b for a, b in zip(x, y))
             for x, y in zip(after, before)]
    assert moved[0] == moved[1] == (1, 1, 1), moved


@pytest.fixture()
def force_mesh(monkeypatch):
    """The forced mesh and batching for the daemon path in both packages,
    with fresh process singletons."""
    import ceph_tpu.rados.osd as ref_osd
    import ceph_tpu_torch.rados.osd as port_osd

    monkeypatch.setenv("CEPH_TPU_FORCE_BATCH", "1")
    monkeypatch.setenv("CEPH_TPU_MESH", "1")
    monkeypatch.setattr(ref_mesh, "_SHARED", None)
    monkeypatch.setattr(ref_mesh, "_SHARED_FAILED", False)
    monkeypatch.setattr(mesh, "_SHARED", {})
    for mod in (ref_osd, port_osd):
        monkeypatch.setattr(mod, "_BATCH_QUEUE", None)
        monkeypatch.setattr(mod, "_PLANAR_STORE", None)
    yield ref_osd, port_osd
    for mod in (ref_osd, port_osd):
        if mod._BATCH_QUEUE is not None:
            mod._BATCH_QUEUE.close()


def test_concurrent_osd_puts_ride_the_mesh_on_both(force_mesh):
    from ceph_tpu.rados.vstart import Cluster as RefCluster
    from ceph_tpu_torch.rados.vstart import Cluster

    blobs = [np.random.default_rng(30 + i).integers(
        0, 256, 50_000, dtype=np.uint8).tobytes() for i in range(12)]

    async def go(cluster, osdmod):
        await cluster.start()
        try:
            c = await cluster.client()
            pool = await c.create_pool("mq", profile=dict(PROFILE))
            q = osdmod.shared_batching_queue(
                *(("cpu",) if osdmod is force_mesh[1] else ()))
            assert q is not None and q.mesh is not None
            assert q.mesh.n_devices == 8
            await c.put(pool, "warm", os.urandom(8192))
            d0, s0 = q.dispatches, q.sharded_dispatches
            await asyncio.gather(*(c.put(pool, f"o{i}", blob)
                                   for i, blob in enumerate(blobs)))
            dispatches = q.dispatches - d0
            sharded = q.sharded_dispatches - s0
            got = [bytes(await c.get(pool, f"o{i}"))
                   for i in range(len(blobs))]
            await c.stop()
            return dispatches, sharded, got
        finally:
            await cluster.stop()

    conf = {"osd_auto_repair": False, "client_op_timeout": 60.0}
    runs = [asyncio.run(asyncio.wait_for(go(cluster, mod), 180))
            for cluster, mod in (
                (RefCluster(n_osds=3, conf=dict(conf)), force_mesh[0]),
                (Cluster(n_osds=3, conf={**conf, "osd_ec_device": "cpu"}),
                 force_mesh[1]))]
    for dispatches, sharded, got in runs:
        assert 0 < dispatches < len(blobs)  # coalesced
        assert sharded == dispatches  # every dispatch rode the mesh
        assert got == blobs
    assert runs[0][2] == runs[1][2]
