"""The page-addressed K5 and K6 against ceph_tpu on the same seeded inputs.

``to_packedbit_paged`` and ``from_packedbit_paged`` serve the paged store's
device arm: an admit writes its plane words straight into its pages, and
``read``, ``planar_rows``, ``planar_shard_bytes`` and
``planar_object_bytes`` go from the pages to the bytes in one launch.  Here
the port's device arm runs on torch CPU tensors, where the two wrappers take
their plain versions, and every case is one op sequence run on it and on the
reference's device arm (jax-cpu): every output, ``stats()``,
``page_stats()`` and the ``pagestore`` counters must be identical, and each
object read must equal the object.  Pages are 256 bytes and the pool holds
300 of them, so a resident spans many pages and, past a filler of 250
pages, both sub-slabs.  A numpy model of the kernels' index arithmetic is
held against the plain versions.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops.gf2 import to_packedbit as ref_to_packedbit
from ceph_tpu.rados import ecutil as ref_ecutil
from ceph_tpu.rados import pagestore as ref
from ceph_tpu_torch.ops import cuda_packedbit as pb
from ceph_tpu_torch.ops.slab import PageTable, new_subslab
from ceph_tpu_torch.rados import ecutil
from ceph_tpu_torch.rados.pagestore import PagedResidentStore

PAGE = 256          # bytes: 64 plane words a page
POOL = 300          # pages: more than a sub-slab's 256
FILL = 250          # pages of the filler installed first

# k, m, chunk bytes (cs), stripes, object_size less than k*cs*stripes by
CASES = {
    # 15 words a plane row: rows and shards start mid-page and straddle pages
    "row straddles pages": dict(k=4, m=2, cs=160, stripes=3, short=0),
    "pages recycled after evictions": dict(k=4, m=2, cs=160, stripes=3,
                                           short=0, recycle=True),
    "partial after shed_parity": dict(k=4, m=2, cs=160, stripes=3, short=0,
                                      shed=True),
    "object_size not a stripe multiple": dict(k=4, m=2, cs=160, stripes=3,
                                              short=333),
    "cs a multiple of 32": dict(k=3, m=2, cs=64, stripes=5, short=0),
    "cs not a multiple of 32": dict(k=3, m=2, cs=100, stripes=3, short=41),
    "admit then read": dict(k=4, m=2, cs=160, stripes=3, short=7,
                            admit=True),
}


def shard_rows(k, m, cs, stripes, seed):
    """(k+m) rows of cs*stripes random bytes: an object's shard rows."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (k + m, cs * stripes), dtype=np.uint8)


def words_of(rows):
    """The reference's plane words of `rows` (uint32, width padded to whole
    words)."""
    pad = -rows.shape[1] % 32
    return np.asarray(ref_to_packedbit(np.pad(rows, ((0, 0), (0, pad)))))


def object_of(rows, k, cs, size):
    """The object whose data rows are rows[:k]: stripe-major, cut to size."""
    L = rows.shape[1]
    return rows[:k].reshape(k, L // cs, cs).transpose(1, 0, 2).reshape(
        -1)[:size].tobytes()


def norm(x):
    """An output as comparable plain data: arrays of any package as (shape,
    bytes), so int32 words equal the reference's uint32 words."""
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, list):
        return [norm(v) for v in x]
    if hasattr(x, "__array__") and not isinstance(x, (bytes, bool, int)):
        a = np.ascontiguousarray(np.asarray(x))
        return ("array", a.shape, a.tobytes())
    return x


def counters(st):
    return {k: (v["avgcount"] if isinstance(v, dict) else v)
            for k, v in st.perf.dump().items()}


def sequence(st, eu, case):
    """The case's op sequence on store `st` with ecutil module `eu`;
    returns the log of every output."""
    k, m, cs, stripes = case["k"], case["m"], case["cs"], case["stripes"]
    L = cs * stripes
    size = k * L - case["short"]
    log = []

    def note(label, value):
        log.append((label, norm(value)))

    def put(key, seed):
        rows = shard_rows(k, m, cs, stripes, seed)
        note(f"put {key}", st.put_planar(
            key, words_of(rows), w=8, n_rows=k + m, meta=(1, L, size),
            trim=L, data_rows=k * 8))
        return rows

    def reads(key, rows, version=1):
        got = eu.planar_object_bytes(st, key, version, k, cs, size)
        note(f"object {key}", got)
        if rows is not None:
            assert got == object_of(rows, k, cs, size), key
        note(f"object {key} again", eu.planar_object_bytes(
            st, key, version, k, cs, size))
        note(f"rows {key}", eu.planar_rows(st, key, version))
        for shard in (0, 1, k, k + m - 1):
            note(f"shard {key} {shard}",
                 eu.planar_shard_bytes(st, key, version, shard))
        note(f"read {key}", st.read(key))

    filler = np.zeros((8, FILL * PAGE // 4 // 8), dtype=np.uint32)
    note("put filler", st.put_planar("filler", filler, w=8, n_rows=1,
                                     meta=(1, 0, 0), trim=0))
    note("read filler", st.read("filler"))  # trim 0: rows of no bytes
    note("rows filler", eu.planar_rows(st, "filler", 1))
    objs = {}
    for i, key in enumerate("ABCD"):
        objs[key] = put(key, seed=i)
    if case.get("admit"):
        st.drop("B")
        objs["B"] = shard_rows(k, m, cs, stripes, seed=9)
        note("admit B", st.admit("B", objs["B"], w=8, meta=(1, L, size),
                                 layout="packedbit") is not None)
        note("gather B", st.gather_rows("B", 8, 8 * (k + 1)))
    if case.get("recycle"):
        # A spans both sub-slabs: its pages come back in reverse order
        note("drop A", st.drop("A"))
        note("drop C", st.drop("C"))
        objs["E"] = put("E", seed=5)
        objs["F"] = put("F", seed=6)
        objs["G"] = put("G", seed=7)  # evicts the filler (LRU)
        objs["H"] = put("H", seed=8)
        del objs["A"], objs["C"]
        note("filler gone", "filler" in st)
    if case.get("shed"):
        note("shed A", st.shed_parity("A"))
        # a raw resident of four pages takes A's shed pages
        note("put raw", st.put_raw("R", bytes(range(250)) * 4))
    for key, rows in objs.items():
        reads(key, rows)
    note("stale version", eu.planar_object_bytes(st, "D", 2, k, cs, size))
    note("absent", eu.planar_object_bytes(st, "Z", 1, k, cs, size))
    note("stats", st.stats())
    note("page stats", st.page_stats())
    note("counters", counters(st))
    # rows that are not whole chunks raise where the reference's reshape
    # does (a resident read for the first time: no memo answers)
    put("Y", seed=11)
    try:
        eu.planar_object_bytes(st, "Y", 1, k, cs + 1, size)
        note("odd chunks", "served")
    except ValueError:
        note("odd chunks", "ValueError")
    return log


@pytest.mark.parametrize("name", list(CASES))
def test_paged_reads_match_reference(name, monkeypatch):
    case = CASES[name]
    want_st = ref.PagedResidentStore(POOL * PAGE, PAGE, device=True)
    st = PagedResidentStore(POOL * PAGE, PAGE, device="cpu", device_arm=True)
    assert want_st.device_arm and st.device_arm
    launches = (pb.from_packedbit_paged.launches,
                pb.to_packedbit_paged.launches)
    want = sequence(want_st, ref_ecutil, case)
    # every read of the port's words takes the paged route
    calls = {"k6": 0, "k5": 0}
    for name_, plain in (("k6", pb.from_packedbit_paged_plain),
                         ("k5", pb.to_packedbit_paged_plain)):
        def counted(*args, _plain=plain, _name=name_):
            calls[_name] += 1
            return _plain(*args)

        monkeypatch.setattr(pb, plain.__name__, counted)

    def no_gather_exit(*args):
        raise AssertionError("a packed-bit read gathered its rows")

    monkeypatch.setattr(ecutil, "_pack_rows", no_gather_exit)
    got = sequence(st, ecutil, case)
    assert calls["k6"] > 0 and calls["k5"] == int(bool(case.get("admit")))
    assert [label for label, _ in got] == [label for label, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert g == w, label
    assert st.page_stats()["device_slabs"] == 2
    assert st._slabs == [], "the device arm touched host pages"
    # the CPU runs the plain versions: nothing launched
    assert (pb.from_packedbit_paged.launches,
            pb.to_packedbit_paged.launches) == launches


# ------------------------------------------------- the kernels' index model --

def _table(rng, page_words, n_pages, subslabs=2):
    """A page table of n_pages scattered over `subslabs` CPU sub-slabs of
    random words, in random order."""
    slabs = {s: new_subslab(256, page_words, torch.device("cpu"))
             for s in range(subslabs)}
    for slab in slabs.values():
        slab.copy_(torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, slab.shape, dtype=np.int64).astype(np.int32)))
    pages = rng.permutation(256 * subslabs)[:n_pages]
    return PageTable(pages, slabs, page_words, 8)


def _page_word(table, flat):
    """page_word(): the word at flat index `flat` (numpy, vectorised)."""
    p = flat // table.page_words
    ids = np.asarray(table.pages)[p]
    host = {s: t.numpy().view(np.uint32) for s, t in table.slabs.items()}
    out = np.empty(flat.shape, dtype=np.uint32)
    for s, a in host.items():
        sel = (ids >> 8) == s
        out[sel] = a[ids[sel] & 255, flat[sel] - p[sel] * table.page_words]
    return out


def plane_words_model(table, flat, step):
    """plane_words(): the words flat + x*step, x < 8, found by one division
    and then stepping each page and offset (vectorised over `flat`)."""
    pw = table.page_words
    p, off = flat // pw, flat % pw
    q, r = divmod(step, pw)
    out = []
    for _ in range(8):
        out.append(_page_word(table, p * pw + off))
        p, off = p + q, off + r
        carry = off >= pw
        off, p = np.where(carry, off - pw, off), p + carry
    return np.stack(out)


def paged_k6_model(table, w0, row_words, out_rows, L, cs, limit):
    """from_packedbit_paged_kernel, thread by thread: thread (w, o) reads
    plane words flat + x*row_words through the page table, transposes them
    into 32 bytes and stores the first min(32, L - 32w) of them."""
    nw = -(-L // 32)
    w, o = np.meshgrid(np.arange(nw), np.arange(out_rows))
    flat = w0 + o * 8 * row_words + w
    wx = plane_words_model(table, flat, row_words)          # [8, rows, nw]
    bits = (wx[:, :, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    u = np.zeros(bits.shape[1:], dtype=np.uint8)           # [rows, nw, 32]
    for x in range(8):
        u |= (bits[x] << x).astype(np.uint8)
    c = 32 * w[:, :, None] + np.arange(32)
    real = c < L
    if cs == 0:
        out = np.full(out_rows * L, 7, dtype=np.uint8)
        out[(o[:, :, None] * L + c)[real]] = u[real]
        return out.reshape(out_rows, L)
    out = np.full(limit, 7, dtype=np.uint8)
    dst = (c // cs) * out_rows * cs + o[:, :, None] * cs + c % cs
    if cs % 32 == 0:  # one run from the thread's first byte's place
        base = dst[:, :, :1]
        assert np.array_equal(dst, base + np.arange(32))
    keep = real & (dst < limit)
    out[dst[keep]] = u[keep]
    return out


@pytest.mark.parametrize("page_words,row_words,L,cs", [
    (64, 15, 480, 160),     # rows straddle pages, chunks of 5 words
    (64, 10, 300, 100),     # a chunk ends mid-word
    (100, 7, 200, 0),       # pages that are not a power of two, shard rows
    (64, 10, 320, 64),
    (16, 40, 1280, 128),    # a plane row longer than two pages
])
def test_paged_k6_index_model_matches_plain(page_words, row_words, L, cs):
    rng = np.random.default_rng(row_words * 1000 + L)
    out_rows = 3
    w0 = 5 * row_words  # the range starts mid-page
    words = w0 + out_rows * 8 * row_words
    table = _table(rng, page_words, -(-words // page_words) + 1)
    for limit in ((out_rows * L, out_rows * L - 77) if cs else (0,)):
        got = pb.from_packedbit_paged(table, w0, row_words, out_rows, L, cs,
                                      limit).numpy()
        want = paged_k6_model(table, w0, row_words, out_rows, L, cs, limit)
        assert np.array_equal(got, want)


def test_paged_k5_index_model_matches_plain():
    """to_packedbit_paged_kernel, thread by thread: word column w of row j
    -> plane words (j*8+x)*W + w through the page table, and the extra row
    of blocks zeroes the last page's tail; nothing outside the pages
    changes."""
    rng = np.random.default_rng(77)
    n, B, page_words = 3, 1000, 64
    W = -(-B // 32)
    total = n * 8 * W
    table = _table(rng, page_words, -(-total // page_words))
    before = {s: t.clone() for s, t in table.slabs.items()}
    data = torch.from_numpy(rng.integers(0, 256, (n, B), dtype=np.uint8))
    pb.to_packedbit_paged(data, table)
    words = pb.to_packedbit_plain(data).numpy().view(np.uint32).reshape(-1)
    end = len(table.pages) * page_words
    flat = np.arange(end)
    want = np.concatenate([words, np.zeros(end - total, dtype=np.uint32)])
    assert np.array_equal(_page_word(table, flat), want)
    mask = np.ones((2, 256), dtype=bool)
    for p in table.pages:
        mask[p >> 8, p & 255] = False
    for s, t in table.slabs.items():
        assert torch.equal(t[mask[s]], before[s][mask[s]])


def test_paged_wrappers_refuse_what_the_kernels_do_not_take():
    rng = np.random.default_rng(3)
    table = _table(rng, 64, 4)
    with pytest.raises(ValueError, match="words in a page table"):
        pb.from_packedbit_paged(table, 0, 10, 4, 300)
    with pytest.raises(ValueError, match="cs 7"):
        pb.from_packedbit_paged(table, 0, 10, 1, 300, cs=7)
    with pytest.raises(ValueError, match="bytes from 10 words"):
        pb.from_packedbit_paged(table, 0, 10, 1, 321)
    with pytest.raises(ValueError, match="pages for"):
        pb.to_packedbit_paged(torch.zeros((1, 32), dtype=torch.uint8), table)
