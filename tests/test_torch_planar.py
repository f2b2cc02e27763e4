"""PlanarShardStore and ecutil's residency helpers against ceph_tpu's on the
same seeded inputs, byte for byte.

The store: admit, read, apply (K3 on packed-bit words, K2 on int8 planes;
directly and through the queue) and LRU eviction.  ecutil:
`planar_encode_async` through the port's queue against the reference's
through its queue, and without a queue; then `planar_rows`,
`planar_shard_bytes` and `planar_object_bytes` over both store kinds (the
paged store on both arms), for w=8 and w=16.  The reference's queue pads a
resident to a pow2 width and the port's does not, so resident words are
compared trimmed to the object's width.
"""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import registry as ref_registry
from ceph_tpu.parallel.service import BatchingQueue as RefQueue
from ceph_tpu.parallel.service import PlanarShardStore as RefStore
from ceph_tpu.rados import ecutil as ref
from ceph_tpu.rados.pagestore import PagedResidentStore as RefPaged
from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
from ceph_tpu_torch.ec.registry import registry
from ceph_tpu_torch.parallel.service import BatchingQueue, PlanarShardStore
from ceph_tpu_torch.rados import ecutil
from ceph_tpu_torch.rados.pagestore import PagedResidentStore

PROFILES = {
    8: {"technique": "reed_sol_van", "k": "8", "m": "3"},
    16: {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "16"},
}
UNIT = 1024  # chunk bytes a stripe
LOST = (1, 5)


def codecs(w):
    profile = dict(PROFILES[w], plugin="jerasure")
    return (registry.factory("jerasure", "", dict(profile)),
            ref_registry.factory("jerasure", "", dict(profile)))


def payload(seed, k, stripes=3, tail=333):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, stripes * k * UNIT - tail,
                        dtype=np.uint8).tobytes()


def as_bytes(x):
    """Rows as comparable bytes (int32 words equal the reference's uint32)."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    a = np.ascontiguousarray(np.asarray(x))
    return a.shape, a.tobytes()


def decode_bitmatrix(codec, lost, n_chunks):
    """A bit-matrix over every chunk's rows (data and parity) rebuilding the
    `lost` data chunks from the codec's chosen survivors."""
    w = codec.w
    chosen, inv = codec.decode_selection(set(lost),
                                         set(range(n_chunks)) - set(lost))
    bm = matrix_to_bitmatrix(inv[list(lost)], w)
    out = np.zeros((bm.shape[0], n_chunks * w), dtype=np.uint8)
    for i, c in enumerate(chosen):
        out[:, c * w:(c + 1) * w] = bm[:, i * w:(i + 1) * w]
    return out


@pytest.fixture(scope="module")
def queues():
    mine = BatchingQueue(device="cpu", max_delay=0.01)
    theirs = RefQueue(max_delay=0.01, mesh=False)
    yield mine, theirs
    mine.close()
    theirs.close()
    assert not mine._worker.is_alive()


@pytest.mark.parametrize("layout,queued", [
    ("packedbit", False), ("packedbit", True), ("planes", False),
    ("planes", True)])
def test_planar_store_matches_reference(layout, queued, queues):
    codec, _ = codecs(8)
    rng = np.random.default_rng(len(layout) + queued)
    objs = []
    for _ in range(3):  # data and parity rows of an encoded object
        data = rng.integers(0, 256, (8, 3000), dtype=np.uint8)
        objs.append(np.vstack([data, np.asarray(codec.encode_chunks(data))]))
    # words: 88 rows x 94 words x 4 B; planes: 88 x 3000: room for two
    per = 88 * 94 * 4 if layout == "packedbit" else 88 * 3000
    mine = PlanarShardStore(2 * per + 100, queue=queues[0] if queued else None,
                            device="cpu")
    theirs = RefStore(2 * per + 100, queue=queues[1] if queued else None)
    for i, rows in enumerate(objs):
        a = mine.admit(f"o{i}", rows, meta=(i,), layout=layout)
        b = theirs.admit(f"o{i}", rows, meta=(i,), layout=layout)
        assert as_bytes(a) == as_bytes(b)
    assert "o0" not in mine and mine.stats() == theirs.stats()
    assert mine.entries_snapshot() == theirs.entries_snapshot()
    for i in (1, 2):
        got = mine.read(f"o{i}")
        np.testing.assert_array_equal(got, objs[i])
        np.testing.assert_array_equal(got, theirs.read(f"o{i}"))
    assert mine.read("o0") is None and theirs.read("o0") is None
    # rebuild data chunks 1 and 5 from the resident rows
    bm = decode_bitmatrix(codec, LOST, 11)
    mat = bm if layout == "packedbit" else bm.astype(np.int8)
    got = mine.apply("o2", mat, len(LOST), out_key="fix")
    want = theirs.apply("o2", mat, len(LOST), out_key="fix")
    assert as_bytes(got) == as_bytes(want)
    fixed = mine.read("fix")
    np.testing.assert_array_equal(fixed, theirs.read("fix"))
    np.testing.assert_array_equal(fixed[:, :3000], objs[2][list(LOST)])
    assert mine.apply("o0", mat, 2) is None
    assert theirs.apply("o0", mat, 2) is None
    assert mine.stats() == theirs.stats()
    assert mine.drop("fix") and not mine.drop("fix")
    assert mine.perf.get("admit") == 3


@pytest.mark.parametrize("w", [8, 16])
def test_planar_encode_async_matches_reference(w, queues):
    codec, ref_codec = codecs(w)
    k = codec.get_data_chunk_count()
    si = ecutil.StripeInfo(k=k, stripe_width=k * UNIT)
    ref_si = ref.StripeInfo(k=k, stripe_width=k * UNIT)
    data = payload(seed=w, k=k)
    assert ecutil.planar_eligible(codec) == ref.planar_eligible(ref_codec)

    async def both(q, rq):
        return await asyncio.gather(
            ecutil.planar_encode_async(codec, si, data, queue=q,
                                       device="cpu"),
            ref.planar_encode_async(ref_codec, ref_si, data, queue=rq))

    for q, rq in ((queues[0], queues[1]), (None, None)):
        (blobs, bits, n, L, pw), (rblobs, rbits, rn, rL, rw) = asyncio.run(
            both(q, rq))
        assert (n, L, pw) == (rn, rL, rw)
        assert len(blobs) == len(rblobs)
        for a, b in zip(blobs, rblobs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        cols = L // 32 if w == 8 else L // 2
        assert bits.shape[1] == cols  # the port pads nothing
        assert bits.dtype == (torch.int32 if w == 8 else torch.int8)
        assert as_bytes(bits) == as_bytes(np.asarray(rbits)[:, :cols])
    # packet-layout codecs are not eligible
    cauchy = registry.factory("jerasure", "", {
        "plugin": "jerasure", "technique": "cauchy_good", "k": "4",
        "m": "2", "packetsize": "64"})
    assert asyncio.run(ecutil.planar_encode_async(
        cauchy, ecutil.StripeInfo(4, 4 * UNIT), data, device="cpu")) is None


def _stores(kind, arm):
    if kind == "planar":
        return PlanarShardStore(1 << 22, device="cpu"), RefStore(1 << 22)
    return (PagedResidentStore(1 << 22, page_bytes=4096, device="cpu",
                               device_arm=arm),
            RefPaged(1 << 22, page_bytes=4096, device=arm))


def _install(store, key, product, version, k):
    _, bits, n_rows, n_cols, w = product
    meta = (version, n_cols, n_cols * k)
    if isinstance(store, (PagedResidentStore, RefPaged)):
        assert store.put_planar(key, bits, w=w, n_rows=n_rows, meta=meta,
                                trim=n_cols, data_rows=k * w)
    else:
        store.put_planar(key, bits, w=w, n_rows=n_rows, meta=meta)


@pytest.mark.parametrize("kind,arm,w", [
    ("planar", None, 8), ("planar", None, 16), ("paged", False, 8),
    ("paged", True, 8), ("paged", True, 16)])
def test_residency_helpers_match_reference(kind, arm, w, queues):
    codec, ref_codec = codecs(w)
    k = codec.get_data_chunk_count()
    cs = UNIT
    si = ecutil.StripeInfo(k=k, stripe_width=k * cs)
    ref_si = ref.StripeInfo(k=k, stripe_width=k * cs)
    data = payload(seed=100 + w, k=k)
    mine, theirs = _stores(kind, arm)
    product = asyncio.run(ecutil.planar_encode_async(
        codec, si, data, queue=queues[0]))
    ref_product = asyncio.run(ref.planar_encode_async(
        ref_codec, ref_si, data, queue=queues[1]))
    _install(mine, "o", product, 7, k)
    _install(theirs, "o", ref_product, 7, k)
    blobs = product[0]

    def both(name, *args):
        """The port's helper on its store and the reference's on its own,
        with the same arguments: their results must be equal."""
        got = getattr(ecutil, name)(mine, *args)
        want = getattr(ref, name)(theirs, *args)
        if isinstance(got, list):
            assert len(got) == len(want)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        else:
            assert got == want, name
        return got

    rows = both("planar_rows", "o", 7)
    assert len(rows) == len(blobs)
    for a, c in zip(rows, blobs):
        np.testing.assert_array_equal(a, np.asarray(c))
    for shard in (0, k - 1, k):
        assert (both("planar_shard_bytes", "o", 7, shard)
                == np.asarray(blobs[shard]).tobytes())
    assert both("planar_rows", "o", 6) is None
    assert both("planar_shard_bytes", "o", 6, 0) is None
    assert both("planar_object_bytes", "o", 7, k, cs, len(data)) == data
    # the second read is the memo's: no gather leaves the device
    d2h = getattr(mine, "d2h_gathers", 0)
    assert both("planar_object_bytes", "o", 7, k, cs, len(data)) == data
    assert getattr(mine, "d2h_gathers", 0) == d2h
    assert both("planar_object_bytes", "x", 7, k, cs, 1) is None
    if kind == "paged":
        want = theirs.stats()
        if w == 16:
            # the port installs the queue's int8 planes from the device; the
            # reference takes them through the host
            assert (want["h2d_installs"], want["device_installs"]) == (1, 0)
            want.update(h2d_installs=0, device_installs=1)
        assert mine.stats() == want
        for st in (mine, theirs):
            st.memo_put("o", 0, b"")  # another version: the next read gathers
            assert st.shed_parity("o") > 0
        assert both("planar_rows", "o", 7) is None
        assert both("planar_object_bytes", "o", 7, k, cs, len(data)) == data
