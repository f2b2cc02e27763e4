"""The port's ecutil against ceph_tpu's on the same seeded inputs.

Stripe math, the queue encode plan (packed-bit lane, int8 lane under
CEPH_TPU_PACKEDBIT=0, w=16, and a packet-layout codec that stays off the
queue), the queue decode plan with 1-3 erasures, the async and group
variants, and the scatter read.  The reference runs ceph_tpu.rados.ecutil
with its BatchingQueue on JAX's CPU backend; the port runs
ceph_tpu_torch.rados.ecutil with its queue on device="cpu".  Every
comparison is byte for byte.
"""

import asyncio
import pickle

import numpy as np
import pytest

from ceph_tpu.ec.registry import registry as ref_registry
from ceph_tpu.parallel.service import BatchingQueue as RefQueue
from ceph_tpu.rados import ecutil as ref
from ceph_tpu_torch.ec.registry import registry
from ceph_tpu_torch.parallel.service import BatchingQueue
from ceph_tpu_torch.rados import ecutil
from ceph_tpu_torch.rados.messenger import BufferList, as_bytes

TIMEOUT = 60
PROFILES = {
    "rs8": {"technique": "reed_sol_van", "k": "8", "m": "3"},
    "rs4w16": {"technique": "reed_sol_van", "k": "4", "m": "2", "w": "16"},
    "cauchy": {"technique": "cauchy_good", "k": "4", "m": "2",
               "packetsize": "64"},
}
UNIT = 1024  # chunk bytes a stripe: 8 KiB stripes at k=8


def codecs(name):
    """(port codec, reference codec) for a profile, both plugin=jerasure."""
    profile = dict(PROFILES[name], plugin="jerasure")
    return (registry.factory("jerasure", "", dict(profile)),
            ref_registry.factory("jerasure", "", dict(profile)))


def sinfo_pair(k):
    return (ecutil.StripeInfo(k=k, stripe_width=k * UNIT),
            ref.StripeInfo(k=k, stripe_width=k * UNIT))


def payload(seed, stripes, k, tail=333):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, stripes * k * UNIT - tail,
                        dtype=np.uint8).tobytes()


def same_shards(got, want, label):
    assert len(got) == len(want), label
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), \
            f"{label}: shard {i} differs"


@pytest.fixture(scope="module")
def ref_queue():
    q = RefQueue(max_delay=0.02, mesh=False)
    yield q
    q.close()


@pytest.fixture(scope="module")
def port_queue():
    q = BatchingQueue(device="cpu", max_delay=0.02)
    yield q
    q.close()
    assert not q._worker.is_alive(), "the queue thread outlived its tests"


@pytest.mark.parametrize("k,width", [(4, 16384), (2, 8192), (8, 8 * 4096)])
def test_stripe_info_conversions_match_reference(k, width):
    mine, theirs = ecutil.StripeInfo(k, width), ref.StripeInfo(k, width)
    assert mine.chunk_size == theirs.chunk_size
    for off in (0, 1, width - 1, width, width + 5, 5 * width + 77):
        for name in ("logical_to_prev_chunk_offset",
                     "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset",
                     "logical_to_next_stripe_offset"):
            assert getattr(mine, name)(off) == getattr(theirs, name)(off)
        assert (mine.offset_len_to_stripe_bounds(off, 100)
                == theirs.offset_len_to_stripe_bounds(off, 100))
        assert mine.pad_to_stripe(b"x" * off) == theirs.pad_to_stripe(
            b"x" * off)
    aligned = 3 * width
    assert (mine.aligned_logical_offset_to_chunk_offset(aligned)
            == theirs.aligned_logical_offset_to_chunk_offset(aligned))
    assert (mine.aligned_chunk_offset_to_logical_offset(3 * mine.chunk_size)
            == theirs.aligned_chunk_offset_to_logical_offset(
                3 * theirs.chunk_size))
    with pytest.raises(AssertionError):
        ecutil.StripeInfo(k=3, stripe_width=100)


@pytest.mark.parametrize("name,lane", [
    ("rs8", "packedbit"), ("rs8", "packed"), ("rs4w16", "packed"),
    ("cauchy", None)])
def test_batched_encode_matches_reference(name, lane, monkeypatch,
                                          ref_queue, port_queue):
    """With the port's queue, without it, and the reference with its queue:
    the same shards.  rs8 rides the packed-bit lane, or the int8 lane under
    CEPH_TPU_PACKEDBIT=0; w=16 rides the int8 lane; the packet-layout codec
    takes encode_chunks off the queue."""
    if name == "rs8" and lane == "packed":
        monkeypatch.setenv("CEPH_TPU_PACKEDBIT", "0")
    codec, ref_codec = codecs(name)
    k = codec.get_data_chunk_count()
    si, ref_si = sinfo_pair(k)
    data = payload(seed=len(name), stripes=8 if k == 8 else 16, k=k)
    before = port_queue.perf.dump()
    queued = ecutil.batched_encode(codec, si, data, queue=port_queue)
    after = port_queue.perf.dump()
    if lane is None:
        assert after["submit"] == before["submit"], "packet layout queued"
    else:
        assert after[f"submit_{lane}"] == before[f"submit_{lane}"] + 1
    plain = ecutil.batched_encode(codec, si, data, queue=None)
    want = ref.batched_encode(ref_codec, ref_si, data, queue=ref_queue)
    same_shards(queued, want, f"{name} through the port's queue")
    same_shards(plain, want, f"{name} without a queue")
    assert len(queued[0]) * k >= len(data)


@pytest.mark.parametrize("lost", [(1,), (0, 5), (1, 5, 9), (2, 3, 10)])
def test_decode_object_matches_reference(lost, ref_queue, port_queue):
    codec, ref_codec = codecs("rs8")
    si, ref_si = sinfo_pair(8)
    data = payload(seed=sum(lost), stripes=8, k=8, tail=1000)
    shards = ecutil.batched_encode(codec, si, data, queue=None)
    avail = {i: s for i, s in enumerate(shards) if i not in lost}
    d0 = port_queue.dispatches
    got = ecutil.decode_object(codec, si, dict(avail), len(data),
                               queue=port_queue)
    assert port_queue.dispatches == d0 + 1
    assert got == data
    assert ecutil.decode_object(codec, si, dict(avail), len(data)) == data
    assert ref.decode_object(ref_codec, ref_si, dict(avail), len(data),
                             queue=ref_queue) == data


def test_decode_int8_lane_and_w16(monkeypatch, port_queue):
    """The decode plan's int8 route: w=8 under CEPH_TPU_PACKEDBIT=0, and
    w=16, each through `submit`."""
    for name in ("rs8", "rs4w16"):
        codec, _ = codecs(name)
        k = codec.get_data_chunk_count()
        si, _ = sinfo_pair(k)
        data = payload(seed=7, stripes=4, k=k)
        shards = ecutil.batched_encode(codec, si, data, queue=None)
        avail = {i: s for i, s in enumerate(shards) if i not in (0, k - 1)}
        with monkeypatch.context() as mp:
            mp.setenv("CEPH_TPU_PACKEDBIT", "0")
            before = port_queue.perf.get("submit_packed")
            assert ecutil.decode_object(codec, si, avail, len(data),
                                        queue=port_queue) == data
            assert port_queue.perf.get("submit_packed") == before + 1


def test_async_variants_coalesce_concurrent_ops(ref_queue):
    """Concurrent encodes and degraded reads from one event loop coalesce
    into few dispatches and equal the reference's."""
    codec, ref_codec = codecs("rs8")
    si, ref_si = sinfo_pair(8)
    bufs = [payload(seed=100 + i, stripes=1, k=8, tail=i * 50)
            for i in range(8)]
    lost = (1, 5, 9)
    q = BatchingQueue(device="cpu", max_delay=0.05)  # wide window

    async def go(mod, cdc, s, queue):
        outs = await asyncio.gather(*(mod.batched_encode_async(
            cdc, s, b, queue=queue) for b in bufs))
        reads = await asyncio.gather(*(mod.decode_object_async(
            cdc, s, {i: x for i, x in enumerate(o) if i not in lost},
            len(b), queue=queue) for o, b in zip(outs, bufs)))
        return outs, reads

    try:
        outs, reads = asyncio.run(asyncio.wait_for(
            go(ecutil, codec, si, q), TIMEOUT))
        assert q.dispatches <= 4, \
            f"8 concurrent encodes and reads took {q.dispatches} dispatches"
        assert q.perf.dump()["group_size"]["sum"] == 16.0
    finally:
        q.close()
    assert not q._worker.is_alive()
    ref_outs, ref_reads = asyncio.run(asyncio.wait_for(
        go(ref, ref_codec, ref_si, ref_queue), TIMEOUT))
    for i, b in enumerate(bufs):
        same_shards(outs[i], ref_outs[i], f"async encode {i}")
        assert reads[i] == ref_reads[i] == b


def test_group_encode_is_one_submission(ref_queue):
    codec, ref_codec = codecs("rs8")
    si, ref_si = sinfo_pair(8)
    bufs = [payload(seed=200 + i, stripes=2, k=8, tail=i) for i in range(5)]
    q = BatchingQueue(device="cpu", max_delay=60.0)

    async def go():
        task = asyncio.ensure_future(ecutil.batched_encode_group_async(
            codec, si, bufs, queue=q))
        await asyncio.sleep(0)  # the task runs up to its first await
        q.flush()  # the one group, one dispatch
        return await asyncio.wait_for(task, TIMEOUT)

    try:
        outs = asyncio.run(go())
        d = q.perf.dump()
        assert (d["dispatch"], d["submit_group"]) == (1, 1)
        assert d["group_submit_size"]["sum"] == float(len(bufs))
    finally:
        q.close()
    want = asyncio.run(ref.batched_encode_group_async(
        ref_codec, ref_si, bufs, queue=ref_queue))
    for i, b in enumerate(bufs):
        same_shards(outs[i], want[i], f"group item {i}")
        same_shards(outs[i], ecutil.batched_encode(codec, si, b),
                    f"group item {i} against a lone encode")
    # a packet-layout codec takes the plain path for every buffer
    cauchy, _ = codecs("cauchy")
    csi, _ = sinfo_pair(4)
    q = BatchingQueue(device="cpu", max_delay=60.0)
    try:
        cbufs = [payload(seed=9, stripes=2, k=4)]
        outs = asyncio.run(ecutil.batched_encode_group_async(
            cauchy, csi, cbufs, queue=q))
        assert q.submits == 0
        same_shards(outs[0], ecutil.batched_encode(cauchy, csi, cbufs[0]),
                    "packet-layout group")
    finally:
        q.close()


def test_scatter_decode_matches_contiguous(port_queue):
    codec, ref_codec = codecs("rs8")
    si, ref_si = sinfo_pair(8)
    data = payload(seed=77, stripes=6, k=8, tail=2500)
    shards = ecutil.batched_encode(codec, si, data, queue=None)
    blobs = {i: s for i, s in enumerate(shards) if i != 9}  # parity lost
    flat = ecutil.decode_object(codec, si, dict(blobs), len(data))
    scat = ecutil.decode_object(codec, si, dict(blobs), len(data),
                                scatter=True)
    assert isinstance(scat, BufferList) and len(scat) == len(data)
    assert scat.tobytes() == as_bytes(scat) == bytes(scat) == flat == data
    assert pickle.loads(pickle.dumps(scat)) == data
    ref_scat = ref.decode_object(ref_codec, ref_si, dict(blobs), len(data),
                                 scatter=True)
    assert ref_scat.tobytes() == scat.tobytes()
    got = asyncio.run(ecutil.decode_object_async(
        codec, si, dict(blobs), len(data), queue=port_queue, scatter=True))
    assert isinstance(got, BufferList) and got.tobytes() == data
