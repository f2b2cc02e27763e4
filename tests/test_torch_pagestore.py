"""The port's paged resident store against ceph_tpu's on the same seeded
inputs.

One op sequence runs on four stores: the reference's host arm and its
device arm on JAX's CPU backend, and the port's host arm and its device arm
on torch CPU tensors.  It covers ragged widths with 4 KiB pages, partial
`gather_rows`, `read`, LRU eviction, dirty/flush tokens, `shed_parity`, the
memo and `put_raw`.  Every output, `stats()`, `page_stats()` and the
counters must be identical to the reference arm's (plane words compared as
bytes: the port's are int32, the reference's uint32); the port's two arms
must also agree with each other.
"""

import threading

import numpy as np
import pytest
import torch

from ceph_tpu.ops.gf2 import to_packedbit as ref_to_packedbit
from ceph_tpu.rados import pagestore as ref
from ceph_tpu_torch.rados import pagestore
from ceph_tpu_torch.rados.pagestore import (CacheDirtyRecord,
                                            PagedResidentStore,
                                            WritebackRecord)

WIDTHS = (100, 3000, 4096, 4128, 12256, 13)
PAGE = 4096
# 40 pages: the six ragged residents take 38, so later installs evict
CAPACITY = 40 * PAGE


def rows(n, B, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, B), dtype=np.uint8)


def norm(x):
    """An output as comparable plain data: arrays and tensors as (shape,
    bytes), so int32 words equal the reference's uint32 words."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if hasattr(x, "__array__") and not isinstance(x, (bytes, bool, int)):
        a = np.ascontiguousarray(np.asarray(x))
        return ("array", a.shape, a.tobytes())
    if isinstance(x, tuple):
        return tuple(norm(v) for v in x)
    if isinstance(x, list):
        return [norm(v) for v in x]
    return x


def counters(st):
    """The `pagestore` set, time averages by count only."""
    return {k: (v["avgcount"] if isinstance(v, dict) else v)
            for k, v in st.perf.dump().items()}


def sequence(st, words_of):
    """The op sequence; returns the log of every output.  `words_of(rows)`
    is the package's to_packedbit of host rows (the reference's, as numpy,
    for both: a host-sourced install)."""
    log = []

    def note(label, value):
        log.append((label, norm(value)))

    for i, B in enumerate(WIDTHS):
        st.admit(f"o{i}", rows(6, B, seed=i), w=8, meta=(1, B, 6 * B),
                 layout="packedbit")
    for i in range(len(WIDTHS)):
        note(f"read o{i}", st.read(f"o{i}"))
        note(f"gather o{i} 8:40", st.gather_rows(f"o{i}", 8, 40))
        note(f"gather o{i} 3:5", st.gather_rows(f"o{i}", 3, 5))
        note(f"gather o{i} past", st.gather_rows(f"o{i}", 40, 49))
    note("stats after admits", st.stats())
    note("touch o0", st.touch("o0"))
    note("touch absent", st.touch("nope"))
    # numpy uint32 words, bigger than the free pages: evicts from the cold end
    p = rows(3, 20000, seed=11)
    note("put p", st.put_planar("p", words_of(p), w=8, n_rows=3,
                                meta=(2, 20000, 60000), trim=20000,
                                data_rows=16))
    note("evicted", [f"o{i}" in st for i in range(len(WIDTHS))])
    note("read p", st.read("p"))
    note("entries", st.entries_snapshot())
    # dirty install, flush-before-evict, stale tokens
    d = rows(3, 2048, seed=9)
    rec = WritebackRecord(pool_id=1, oid="d", pg=0, version=7,
                          object_size=4096, hinfo=b"", shards=(1,))
    note("put d", st.put_planar("d", words_of(d), w=8, n_rows=3,
                                meta=(7, 2048, 4096), trim=2048,
                                data_rows=16, dirty_rows=[(8, 16)],
                                dirty_info=rec, now=5.0))
    note("drop dirty", st.drop("d"))
    _info, gen = st.peek_dirty("d")
    note("dirty items", [(k, g, t) for k, _i, g, t in st.dirty_items()])
    st.put_planar("d", words_of(rows(3, 2048, seed=10)), w=8, n_rows=3,
                  meta=(8, 2048, 4096), trim=2048, data_rows=16,
                  dirty_rows=[(8, 16)], dirty_info=rec, now=6.0)
    note("stale token", st.clear_dirty("d", gen))
    note("is dirty", st.is_dirty("d"))
    note("fresh token", st.clear_dirty("d", st.peek_dirty("d")[1]))
    note("page stats mid", st.page_stats())
    # partial eviction: the data prefix keeps serving
    note("shed p", st.shed_parity("p"))
    note("get p partial", st.get_planar("p"))
    note("gather p data", st.gather_rows("p", 0, 16))
    note("read p partial", st.read("p"))
    # the memo: page-rounded, dies with the entry
    st.memo_put("d", 8, b"x" * 5000)
    note("memo", (st.memo_get("d", 8), st.memo_get("d", 7), st.memo_bytes))
    note("drop d", st.drop("d"))
    note("memo gone", (st.memo_get("d", 8), st.memo_bytes))
    # a raw whole-object resident
    blob = rows(1, 9999, seed=3).tobytes()
    crec = CacheDirtyRecord(pool_id=1, oid="r", pg=2, version=3,
                            object_size=9999, primary=0, peers=(0, 1))
    note("put raw", st.put_raw("r", blob, meta=(3,), dirty_info=crec,
                               now=7.0))
    note("raw", (st.is_raw("r"), st.read_raw("r") == blob, st.read("r")))
    note("refuse oversized", st.put_planar("big", np.zeros(
        (8, 50 * PAGE // 4), dtype=np.uint32), w=8))
    note("peek", st.peek("o5"))
    note("entry nbytes", [st.entry_nbytes(k) for k in ("p", "r", "o5")])
    st.capacity_bytes = CAPACITY // 2  # the budget only grows
    note("stats", st.stats())
    note("page stats", st.page_stats())
    note("counters", counters(st))
    return log


def ref_words(r):
    return np.asarray(ref_to_packedbit(r))


@pytest.fixture(scope="module")
def ref_logs():
    out = {}
    for arm in (False, True):
        st = ref.PagedResidentStore(capacity_bytes=CAPACITY, page_bytes=PAGE,
                                    device=arm)
        assert st.device_arm == arm
        out[arm] = sequence(st, ref_words)
    return out


@pytest.mark.parametrize("arm", [False, True], ids=["host", "device"])
def test_op_sequence_matches_reference(arm, ref_logs):
    st = PagedResidentStore(capacity_bytes=CAPACITY, page_bytes=PAGE,
                            device="cpu", device_arm=arm)
    assert st.device_arm == arm
    got = sequence(st, ref_words)
    want = ref_logs[arm]
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert g == w, label
    if arm:
        assert st._slabs == [], "the device arm touched host pages"
        assert all(s.dtype == torch.int32 for s in st._dev_slabs if s is not None)


def test_port_arms_agree_on_every_output():
    """The port's two arms differ only in the device counters."""
    device_keys = {"device_arm", "device_slabs", "h2d_installs",
                   "device_installs", "d2h_gathers"}

    def run(arm):
        st = PagedResidentStore(capacity_bytes=CAPACITY, page_bytes=PAGE,
                                device="cpu", device_arm=arm)
        return [(label, {k: x for k, x in v.items() if k not in device_keys}
                 if isinstance(v, dict) else v)
                for label, v in sequence(st, ref_words)]

    assert run(False) == run(True)


def test_device_native_install_of_a_device_product():
    """A tensor on the store's device installs with no host copy
    (device_installs), packed-bit words and int8 planes alike; the
    reference takes its int8 planes through the host (h2d_installs)."""
    st = PagedResidentStore(capacity_bytes=1 << 20, page_bytes=PAGE,
                            device="cpu", device_arm=True)
    refst = ref.PagedResidentStore(capacity_bytes=1 << 20, page_bytes=PAGE,
                                   device=True)
    r = rows(8, 3001, seed=21)
    for s in (st, refst):
        s.admit("pl", r, w=8, layout="planes")
        s.admit("pb", r, w=8, layout="packedbit")
    for key in ("pl", "pb"):
        np.testing.assert_array_equal(st.read(key), refst.read(key))
        np.testing.assert_array_equal(st.read(key), r)
    np.testing.assert_array_equal(st.gather_rows("pl", 8, 16).numpy(),
                                  np.asarray(refst.gather_rows("pl", 8, 16)))
    assert st.gather_rows("pl", 8, 16).dtype == torch.int8
    assert (st.device_installs, st.h2d_installs) == (2, 0)
    assert (refst.device_installs, refst.h2d_installs) == (1, 1)


def test_gather_survives_a_later_install_to_the_same_subslab():
    st = PagedResidentStore(capacity_bytes=1 << 20, page_bytes=PAGE,
                            device="cpu", device_arm=True)
    a = rows(3, 2048, seed=31)
    st.admit("a", a, w=8, layout="packedbit")
    early = st.gather_rows("a", 0, 24)
    kept = early.clone()
    st.drop("a")
    for i in range(8):  # reuse a's pages in the same sub-slab
        st.admit(f"b{i}", rows(3, 2048, seed=40 + i), w=8,
                 layout="packedbit")
    assert torch.equal(early, kept)
    np.testing.assert_array_equal(early.numpy().view(np.uint32),
                                  ref_words(a)[:24])


def test_installs_racing_gathers_keep_every_read_whole():
    """Installers and readers on one store: every read is the pinned key's
    exact bytes (the store's mutex orders installs against gathers)."""
    import sys

    st = PagedResidentStore(capacity_bytes=1 << 20, page_bytes=PAGE,
                            device="cpu", device_arm=True)
    pinned = rows(3, 2048, seed=50)
    st.admit("pin", pinned, w=8, layout="packedbit")
    errors, stop = [], threading.Event()

    def installer(seed):
        i = 0
        while not stop.is_set() and i < 200:
            st.admit(f"w{seed}-{i % 4}", rows(3, 2048, seed=seed + i % 4),
                     w=8, layout="packedbit")
            i += 1

    def reader():
        for _ in range(200):
            got = st.read("pin")
            if got is None or not np.array_equal(got, pinned):
                errors.append("torn read")
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=installer, args=(s,))
                    for s in (60, 70)]
                   + [threading.Thread(target=reader) for _ in range(2)])
        for t in threads:
            t.start()
        for t in threads[2:]:
            t.join(timeout=30)
        stop.set()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_arm_selection_and_device(monkeypatch):
    assert not PagedResidentStore(page_bytes=PAGE, device="cpu").device_arm
    monkeypatch.setenv("CEPH_TPU_DEVICE_SLAB", "1")
    assert PagedResidentStore(page_bytes=PAGE, device="cpu",
                              device_arm=False).device_arm
    monkeypatch.setenv("CEPH_TPU_DEVICE_SLAB", "0")
    assert not PagedResidentStore(page_bytes=PAGE, device="cpu",
                                  device_arm=True).device_arm
    assert not pagestore.device_slab_resolved(True, device="cpu")
    monkeypatch.delenv("CEPH_TPU_DEVICE_SLAB")
    assert not pagestore.device_slab_resolved(None, device="cpu")
    # no arguments: the card, which this host does not have
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedResidentStore()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pagestore.install_staging(100)


def test_install_staging_is_aligned_host_memory_on_the_cpu():
    mv = pagestore.install_staging(10000, device="cpu")
    want = ref.install_staging(10000)
    assert (mv.nbytes, mv.format) == (want.nbytes, want.format)
    assert np.frombuffer(mv, dtype=np.uint8).ctypes.data % 4096 == 0
