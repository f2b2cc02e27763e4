"""The port's packed-bit XOR-schedule lane (ceph_tpu_torch.ops.gf2 and
ops/cuda_packedbit.py) against ceph_tpu.ops.gf2 on the CPU, where the
kernels' wrappers run their plain versions.  Inputs come from numpy seeds and
the same arrays go to both packages.  Exact equality throughout: this is
integer GF(2).  Plane words are compared as u32 (`.numpy().view(np.uint32)`).

Also numpy models of what the CUDA kernels do that the plain versions do not:
K4's register transposes (8x8 bit transposes and byte permutes, word by
word) and the encoded instruction list with its liveness-allocated temp
slots."""

import functools
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceph_tpu.ops.gf2 as ref
import ceph_tpu_torch.ops.gf2 as port
from ceph_tpu_torch.ec import matrices as M
from ceph_tpu_torch.ec.plugins import cuda as cuda_plugin
from ceph_tpu_torch.ec.plugins.cuda import CudaPlugin
from ceph_tpu_torch.ec.plugins.jerasure import JerasurePlugin
from ceph_tpu_torch.ops import cuda_packedbit as kern
from tests.test_codecs import make, payload


@pytest.fixture(autouse=True)
def pinned_backend(monkeypatch):
    """Pin ceph_tpu's backend probe to a live verdict so plugin=tpu runs its
    device seam here (as tests/test_tpu.py does) rather than its fallback."""
    from ceph_tpu.utils import jaxdev

    verdict = jaxdev._result if jaxdev._result not in (None, jaxdev.UNAVAILABLE) else "cpu"
    monkeypatch.setattr(jaxdev, "_result", verdict)


@functools.cache
def matrices():
    """The main path's bit-matrices, k=20 m=6, random ones (sparse and
    dense), a single term and an all-zero one."""
    rs = JerasurePlugin().factory({"plugin": "jerasure", "k": "8", "m": "3",
                                   "technique": "reed_sol_van"})
    _, inv = rs.decode_selection({0, 4, 7}, set(range(11)) - {0, 4, 7})
    cauchy = M.matrix_to_bitmatrix(M.cauchy_good_matrix(8, 3, 8), 8)
    full = np.vstack([np.eye(64, dtype=np.uint8), cauchy])
    chosen = tuple(c for c in range(11) if c not in (1, 5, 9))[:8]
    rng = np.random.default_rng(31)
    return {
        "rs_encode": M.matrix_to_bitmatrix(M.vandermonde_coding_matrix(8, 3, 8), 8),
        "rs_decode3": M.matrix_to_bitmatrix(inv[[0, 4, 7]], 8),
        "cauchy_good": cauchy,
        "cauchy_decode3": M.invert_bitmatrix(
            np.vstack([full[c * 8:(c + 1) * 8] for c in chosen])),
        "k20m6": M.matrix_to_bitmatrix(M.vandermonde_coding_matrix(20, 6, 8), 8),
        "random": rng.integers(0, 2, (16, 40), dtype=np.uint8),
        # temps past the port's first term space (2 * C) in the CSE pass
        "dense": (rng.random((48, 40)) < 0.9).astype(np.uint8),
        "sparse": (rng.random((24, 100)) < 0.2).astype(np.uint8),
        "single": np.ones((1, 1), dtype=np.uint8),
        "zero": np.zeros((8, 16), dtype=np.uint8),
    }


def u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def i32(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def program(name: str, cse: bool = True) -> kern.Program:
    bm = matrices()[name]
    ops, outs, _ = port.xor_schedule_program(bm, cse=cse)
    return kern.Program(ops, outs, bm.shape[1])


# -- the schedule compiler ----------------------------------------------------

@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("name", ["rs_encode", "rs_decode3", "cauchy_good",
                                  "cauchy_decode3", "k20m6", "random", "dense",
                                  "sparse", "single", "zero"])
def test_xor_schedule_program_identical_to_reference(name, cse):
    bm = matrices()[name]
    assert port.xor_schedule_program(bm, cse=cse) == \
        ref.xor_schedule_program(bm, cse=cse)


def test_xor_op_counts_of_the_main_path():
    """XORs without and with CSE (the counts the schedules are sized by)."""
    want = {"rs_encode": (441, 230), "rs_decode3": (678, 304),
            "cauchy_good": (463, 244), "cauchy_decode3": (348, 153)}
    for name, counts in want.items():
        bm = matrices()[name]
        got = tuple(port.xor_schedule_program(bm, cse=c)[2] for c in (False, True))
        assert got == counts, name


def test_switches_read_the_reference_variables(monkeypatch):
    assert port.packedbit_enabled() and port.xor_cse_enabled()
    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", "0")
    monkeypatch.setenv("CEPH_TPU_XOR_CSE", "0")
    assert not port.packedbit_enabled() and not ref.packedbit_enabled()
    assert not port.xor_cse_enabled() and not ref.xor_cse_enabled()
    bm = matrices()["rs_encode"]
    assert port.xor_schedule_program(bm)[0] == []  # no temps without CSE


# -- converters ---------------------------------------------------------------

@pytest.mark.parametrize("B", [32, 1024])
def test_to_and_from_packedbit_match_reference(B):
    data = np.random.default_rng(B).integers(0, 256, (8, B), dtype=np.uint8)
    want = np.asarray(ref.to_packedbit(jnp.asarray(data)))
    got = port.to_packedbit(torch.from_numpy(data))
    assert got.dtype == torch.int32 and np.array_equal(u32(got), want)
    back = port.from_packedbit(got, 8)
    assert np.array_equal(back.numpy(),
                          np.asarray(ref.from_packedbit(jnp.asarray(want), 8)))
    assert np.array_equal(back.numpy(), data)


@pytest.mark.parametrize("B", [1, 31, 33, 1000])
def test_host_bitplane_helpers_match_reference(B):
    data = np.random.default_rng(B).integers(0, 256, (3, B), dtype=np.uint8)
    words = port.pack_bitplanes_u32(data)
    assert np.array_equal(words, ref.pack_bitplanes_u32(data))
    assert np.array_equal(port.pack_bitplanes_u32(data, 4),
                          ref.pack_bitplanes_u32(data, 4))
    assert np.array_equal(port.unpack_bitplanes_u32(words, 8, 3, B), data)
    # the device converter pads ragged B the same way
    assert np.array_equal(u32(port.to_packedbit(torch.from_numpy(data))), words)


# -- the lane -----------------------------------------------------------------

def test_gf2_xor_packed_matches_reference():
    """On plane words, on uint8 packet rows, and on a data ‖ parity resident
    with more rows than the program's C (temps must not shift)."""
    rng = np.random.default_rng(41)
    bm = matrices()["rs_encode"]
    planes = rng.integers(0, 2**32, (64, 32), dtype=np.uint32)
    got = port.gf2_xor_packed(bm, i32(planes))
    assert got.dtype == torch.int32
    assert np.array_equal(u32(got), np.asarray(ref.gf2_xor_packed(bm, planes)))
    rows = rng.integers(0, 256, (64, 256), dtype=np.uint8)
    cg = matrices()["cauchy_good"]
    got = port.gf2_xor_packed(cg, torch.from_numpy(rows))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), np.asarray(ref.gf2_xor_packed(cg, rows)))
    resident = rng.integers(0, 2**32, (88, 32), dtype=np.uint32)
    assert np.array_equal(u32(port.gf2_xor_packed(bm, i32(resident))),
                          np.asarray(ref.gf2_xor_packed(bm, resident)))
    assert np.array_equal(u32(port.gf2_xor_packed(bm, i32(resident))),
                          u32(port.gf2_xor_packed(bm, i32(resident[:64]))))


@pytest.mark.parametrize("name", ["rs_encode", "rs_decode3"])
def test_gf2_apply_packedbit_matches_reference(name):
    bm = matrices()[name]
    data = np.random.default_rng(43).integers(0, 256, (8, 1024), dtype=np.uint8)
    want = np.asarray(ref.gf2_apply_packedbit(bm, jnp.asarray(data)))
    assert np.array_equal(
        port.gf2_apply_packedbit(bm, torch.from_numpy(data)).numpy(), want)
    # ragged B: the port masks its edge; columns are independent, so the
    # reference's first 1000 columns are the answer
    got = port.gf2_apply_packedbit(bm, torch.from_numpy(data[:, :1000].copy()))
    assert np.array_equal(got.numpy(), want[:, :1000])


def test_gf2_encode_packedbit_resident_matches_reference():
    bm = matrices()["rs_encode"]
    data = np.random.default_rng(44).integers(0, 256, (8, 1024), dtype=np.uint8)
    packed, planes = ref.gf2_encode_packedbit_resident(bm, jnp.asarray(data))
    got_packed, got_planes = port.gf2_encode_packedbit_resident(
        bm, torch.from_numpy(data))
    assert np.array_equal(got_packed.numpy(), np.asarray(packed))
    assert np.array_equal(u32(got_planes), np.asarray(planes))
    assert got_planes.shape == (88, 32)


# -- the schedule LRU and gf2_sched ------------------------------------------

def _mat(i: int) -> np.ndarray:
    m = np.zeros((2, 8), dtype=np.uint8)
    m[0, i] = 1
    m[1, (i + 1) % 8] = 1
    return m


def test_schedule_cache_lru_eviction_and_refresh(monkeypatch):
    monkeypatch.setattr(port, "_XOR_SCHEDULES", OrderedDict())
    monkeypatch.setattr(port, "_XOR_SCHEDULE_CAPACITY", 3)
    planes = i32(np.random.default_rng(23).integers(0, 2**32, (8, 4),
                                                    dtype=np.uint32))
    keys = []
    for i in range(3):
        port.gf2_xor_packed(_mat(i), planes)
        keys.append(next(reversed(port._XOR_SCHEDULES)))
    assert len(port._XOR_SCHEDULES) == 3
    assert keys[0] == ("xor", (2, 8), _mat(0).tobytes(), True)
    port.gf2_xor_packed(_mat(0), planes)  # a hit refreshes the oldest
    assert next(reversed(port._XOR_SCHEDULES)) == keys[0]
    port.gf2_xor_packed(_mat(3), planes)  # evicts mat(1), the true LRU
    assert len(port._XOR_SCHEDULES) == 3
    assert keys[1] not in port._XOR_SCHEDULES and keys[0] in port._XOR_SCHEDULES
    port.gf2_xor_packed(_mat(3), planes, cse=False)
    assert len([k for k in port._XOR_SCHEDULES if k[2] == _mat(3).tobytes()]) == 2
    assert port.SCHED_PERF.get("entries") == 3
    port.SCHED_PERF.reset()  # resync re-reads the gauge
    assert port.SCHED_PERF.get("entries") == 3


def _deltas(sched, fn):
    keys = ("hit", "miss", "evict", "compile", "xor_ops_naive", "xor_ops_final")
    before = sched.dump()
    fn()
    after = sched.dump()
    return {k: after[k] - before[k] for k in keys}


def test_sched_counters_move_as_the_reference(monkeypatch):
    """The same calls move the port's gf2_sched counters exactly as the
    reference's: a miss and a compile, then a hit; evictions at capacity."""
    for mod in (port, ref):
        monkeypatch.setattr(mod, "_XOR_SCHEDULES", OrderedDict())
        monkeypatch.setattr(mod, "_XOR_SCHEDULE_CAPACITY", 2)
    rng = np.random.default_rng(99)
    mats = [rng.integers(0, 2, (8, 8), dtype=np.uint8) | np.eye(8, dtype=np.uint8)
            for _ in range(3)]
    planes = rng.integers(0, 2**32, (8, 2), dtype=np.uint32)

    def calls(mod, as_rows):
        def go():
            for bm in mats + mats[:1] + mats[-1:]:
                mod.gf2_xor_packed(bm, as_rows(planes))
        return go

    got = _deltas(port.SCHED_PERF, calls(port, i32))
    want = _deltas(ref.SCHED_PERF, calls(ref, lambda a: a))
    assert got == want
    assert got["miss"] == 4 and got["compile"] == 4 and got["hit"] == 1
    assert got["evict"] == 2 and port.SCHED_PERF.get("entries") == 2
    assert 0 < got["xor_ops_final"] <= got["xor_ops_naive"]


# -- the plugin=cuda seams ----------------------------------------------------

def port_codec(**profile):
    return CudaPlugin().factory(
        {"plugin": "cuda", **{k: str(v) for k, v in profile.items()}},
        device="cpu")


def _spy(monkeypatch, name):
    calls = []
    real = getattr(cuda_plugin, name)

    def spy(bm, x, *a, **kw):
        calls.append(x.dtype)
        return real(bm, x, *a, **kw)

    monkeypatch.setattr(cuda_plugin, name, spy)
    return calls


def _same_chunks(profile, seed, lost):
    """plugin=cuda (device cpu) against plugin=tpu and plugin=jerasure:
    encode, then a decode of `lost`."""
    codec = port_codec(**profile)
    n = codec.get_chunk_count()
    data = payload(1 << 14, seed=seed)
    enc = codec.encode(set(range(n)), data)
    for other in (make("tpu", **profile), make("jerasure", **profile)):
        eo = other.encode(set(range(n)), data)
        for c in range(n):
            assert np.array_equal(enc[c], eo[c]), f"chunk {c} vs {other}"
    out = codec.decode(set(lost), {c: enc[c] for c in enc if c not in lost},
                       len(enc[0]))
    for c in lost:
        assert np.array_equal(out[c], enc[c])
    return codec


def test_cuda_w8_encode_and_decode_ride_the_packedbit_lane(monkeypatch):
    calls = _spy(monkeypatch, "gf2_apply_packedbit")
    profile = dict(technique="reed_sol_van", k=4, m=2)
    codec = port_codec(**profile)
    data = payload(1 << 14, seed=21)
    enc = codec.encode(set(range(6)), data)
    assert calls and all(d == torch.uint8 for d in calls)
    del calls[:]
    out = codec.decode({1, 4}, {c: enc[c] for c in enc if c not in (1, 4)},
                       len(enc[0]))
    assert calls, "decode did not ride the packed-bit lane"
    for c in (1, 4):
        assert np.array_equal(out[c], enc[c])
    _same_chunks(profile, 21, (1, 4))


def test_cuda_packet_rows_ride_gf2_xor_packed(monkeypatch):
    calls = _spy(monkeypatch, "gf2_xor_packed")
    _same_chunks(dict(technique="cauchy_good", k=4, m=2, packetsize=8), 23,
                 (0, 5))
    assert calls and all(d == torch.uint8 for d in calls), calls


@pytest.mark.parametrize("profile", [
    dict(technique="reed_sol_van", k=4, m=2),
    dict(technique="cauchy_good", k=4, m=2, packetsize=8),
])
def test_packedbit_switch_off_never_dispatches_the_lane(monkeypatch, profile):
    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", "0")

    def forbidden(*a, **kw):
        raise AssertionError("packed-bit lane dispatched while disabled")

    monkeypatch.setattr(cuda_plugin, "gf2_apply_packedbit", forbidden)
    monkeypatch.setattr(cuda_plugin, "gf2_xor_packed", forbidden)
    _same_chunks(profile, 22, (1, 4))


# -- numpy models of the kernels ---------------------------------------------

M32 = 0xFFFFFFFF


def transpose8_model(lo: int, hi: int):
    """csrc/packedbit.cu transpose8 on Python ints, 32-bit wrap included."""
    t = (lo ^ (lo >> 7)) & 0x00AA00AA
    lo ^= t ^ ((t << 7) & M32)
    t = (hi ^ (hi >> 7)) & 0x00AA00AA
    hi ^= t ^ ((t << 7) & M32)
    t = (lo ^ (lo >> 14)) & 0x0000CCCC
    lo ^= t ^ ((t << 14) & M32)
    t = (hi ^ (hi >> 14)) & 0x0000CCCC
    hi ^= t ^ ((t << 14) & M32)
    t = (lo ^ ((hi << 4) & M32)) & 0xF0F0F0F0
    return lo ^ t, hi ^ (t >> 4)


def byte_perm(x: int, y: int, s: int) -> int:
    """__byte_perm: byte i of the result is byte (nibble i of s) of y:x."""
    pool = (y << 32) | x
    return sum(((pool >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def gather4_model(s0, s1, s2, s3, x):
    sel = x | ((x + 4) << 4)
    return byte_perm(byte_perm(s0, s1, sel), byte_perm(s2, s3, sel), 0x5410)


def bytes_to_words_model(v):
    """bytes_to_words: eight little-endian words of 32 columns -> the eight
    plane words of that column."""
    lo, hi = zip(*(transpose8_model(v[2 * g], v[2 * g + 1]) for g in range(4)))
    return ([gather4_model(*lo, x) for x in range(4)]
            + [gather4_model(*hi, x) for x in range(4)])


def words_to_bytes_model(w):
    """words_to_bytes: the inverse."""
    v = []
    for g in range(4):
        v += transpose8_model(gather4_model(*w[:4], g), gather4_model(*w[4:], g))
    return v


def test_transpose8_model_is_the_bit_transpose():
    rng = np.random.default_rng(3)
    for lo, hi in rng.integers(0, 2**32, (200, 2), dtype=np.uint64).tolist():
        tlo, thi = transpose8_model(lo, hi)
        src = (hi << 32) | lo
        dst = (thi << 32) | tlo
        for b in range(8):
            for x in range(8):
                assert (src >> (8 * b + x)) & 1 == (dst >> (8 * x + b)) & 1


@pytest.mark.parametrize("B", [1000, 2048])
def test_k4_transposes_model_against_plain(B):
    """K4's per-thread transposes (load32's zero fill past B, bytes_to_words,
    words_to_bytes) give the plain versions' words and bytes."""
    data = np.random.default_rng(B).integers(0, 256, (3, B), dtype=np.uint8)
    W = -(-B // 32)
    padded = np.zeros((3, W * 32), dtype=np.uint8)
    padded[:, :B] = data
    cols = padded.reshape(3, W, 8, 4).view(np.uint32).reshape(3, W, 8)
    got = np.zeros((24, W), dtype=np.uint32)
    for j in range(3):
        for w in range(W):
            got[j * 8:j * 8 + 8, w] = bytes_to_words_model(cols[j, w].tolist())
    assert np.array_equal(got, u32(kern.to_packedbit_plain(torch.from_numpy(data))))
    back = np.zeros((3, W, 8), dtype=np.uint32)
    for o in range(3):
        for w in range(W):
            back[o, w] = words_to_bytes_model(got[o * 8:o * 8 + 8, w].tolist())
    back = back.view(np.uint8).reshape(3, W * 32)
    assert np.array_equal(back[:, :B], data)
    assert np.array_equal(back, kern.from_packedbit_plain(
        torch.from_numpy(got.view(np.int32)), 3).numpy())


def run_encoded(prog: kern.Program, rows: np.ndarray) -> np.ndarray:
    """csrc/packedbit.cu over every column at once: each group's warp walks
    its own sub-program in run_program's order (the operands of step
    p + PREFETCH are loaded before step p stores its result, reading ahead
    past the group's end into the next group's steps and the padding
    steps), over the shared inputs and its own temp slots.  The warps run
    one step each in turn, as concurrent warps may, and no group may write
    what another reads."""
    zero, dummy = prog.n_vals - 2, prog.n_vals - 1
    ahead = kern.PREFETCH
    vals = np.zeros((prog.n_vals, rows.shape[1]), dtype=rows.dtype)
    vals[:prog.C] = rows[:prog.C]
    out = np.full((prog.R, rows.shape[1]), 0xA5, dtype=rows.dtype)
    stored = np.zeros(prog.R, dtype=int)
    code = prog.code.tolist() + [[zero, zero, dummy, 0]] * (ahead + 1)
    walks = []
    for g in range(prog.groups):
        first, end = int(prog.offsets[g]), int(prog.offsets[g + 1])
        walks.append({"p": first, "end": end, "acc": np.zeros_like(vals[0]),
                      "loaded": [(vals[code[q][0]].copy(),
                                  vals[code[q][1]].copy())
                                 for q in range(first, first + ahead)]})
    while any(w["p"] < w["end"] for w in walks):
        for w in walks:
            p = w["p"]
            if p >= w["end"]:
                continue
            a, b, d, meta = code[p]
            assert 0 <= a < dummy and 0 <= b < dummy
            assert d == dummy or prog.C <= d < zero
            na, nb = code[p + ahead][:2]
            w["loaded"].append((vals[na].copy(), vals[nb].copy()))
            xa, xb = w["loaded"].pop(0)
            x = xa ^ xb
            if d != dummy:  # the device stores no output step's result
                vals[d] = x
            w["acc"] = x if meta & kern.FIRST else w["acc"] ^ x
            if meta & kern.LAST:
                out[meta >> 2] = w["acc"]
                stored[meta >> 2] += 1
            w["p"] = p + 1
    assert (stored == 1).all() and not vals[zero].any()
    return out


def group_slots(prog: kern.Program):
    """Each group's temp slots, as value indices: the ones its steps write."""
    zero, dummy = prog.n_vals - 2, prog.n_vals - 1
    return [{d for _, _, d, _ in prog.code[prog.offsets[g]:prog.offsets[g + 1]]
             .tolist() if d != dummy}
            for g in range(prog.groups)]


def test_schedule_keeps_a_temp_and_its_reader_apart():
    """A step never reads a temp that one of the PREFETCH steps before it
    wrote (the kernel has loaded its operands by then): here steps that do
    nothing go between, and the model of the kernel's order gives the plain
    answer, which it does not without them."""
    ops, outs = [(0, 1), (2, 4)], [[5], [3, 5], []]
    steps = kern.schedule_steps(ops, outs, 4)
    assert ("nop",) in steps
    for q, step in enumerate(steps):
        for prev in steps[max(0, q - kern.PREFETCH):q]:
            if prev[0] == "t" and step[0] != "nop":
                assert 4 + prev[1] not in step[2:4]
    prog = kern.Program(ops, outs, 4, groups=1)
    rows = np.random.default_rng(6).integers(0, 256, (4, 16), dtype=np.uint8)
    want = kern.xor_schedule_plain(prog, torch.from_numpy(rows)).numpy()
    assert np.array_equal(run_encoded(prog, rows), want)
    prog.code = prog.code[[i for i, s in enumerate(steps) if s != ("nop",)]]
    prog.offsets = np.array([0, len(prog.code)], dtype=np.int32)
    assert not np.array_equal(run_encoded(prog, rows), want)


@pytest.mark.parametrize("name,cse", [("rs_encode", True), ("rs_decode3", True),
                                      ("cauchy_decode3", True), ("k20m6", True),
                                      ("k20m6", False), ("zero", True)])
def test_encoded_program_model_against_plain(name, cse):
    """The instruction list with liveness-reused slots, split into groups,
    computes what the plain replay of (ops, outs) does, and fits both
    kernels' shared memory at a block of 32 columns."""
    prog = program(name, cse)
    assert prog.groups == min(kern.GROUPS, prog.R)
    rows = np.random.default_rng(5).integers(0, 256, (prog.C + 3, 64),
                                             dtype=np.uint8)
    want = kern.xor_schedule_plain(prog, torch.from_numpy(rows)).numpy()
    assert np.array_equal(run_encoded(prog, rows), want)
    need = kern.row_closures(prog.ops, prog.outs, prog.C)
    temps = 0  # each group's temps; slots are reused within a group
    for rows in prog.rows:
        closure = 0
        for r in rows:
            closure |= need[r]
        temps += closure.bit_count()
    assert prog.n_slots <= temps
    assert kern.xor_schedule_smem(prog, 32, 4) <= kern.MAX_SMEM
    if prog.C % 8 == 0 and prog.R % 8 == 0:
        assert kern.apply_packedbit_smem(prog, 32) <= kern.MAX_SMEM


GROUPED = ["rs_encode", "rs_decode3", "cauchy_good", "cauchy_decode3",
           "k20m6", "zero"]


@pytest.mark.parametrize("groups", [1, 2, 3, 8])
@pytest.mark.parametrize("cse", [True, False])
@pytest.mark.parametrize("name", GROUPED)
def test_grouped_program_model_against_plain(name, cse, groups):
    """Every number of groups: the model of the grouped walk gives the plain
    replay's rows, the partition covers every output row exactly once, and
    each group writes only its own slots."""
    bm = matrices()[name]
    ops, outs, _ = port.xor_schedule_program(bm, cse=cse)
    prog = kern.Program(ops, outs, bm.shape[1], groups=groups)
    assert prog.groups == min(groups, prog.R)
    assert sorted(r for rows in prog.rows for r in rows) == list(range(prog.R))
    rows_of_steps = [{int(m) >> 2 for m in prog.code[prog.offsets[g]:
                                                     prog.offsets[g + 1], 3]
                      if m & kern.LAST} for g in range(prog.groups)]
    assert rows_of_steps == [set(r) for r in prog.rows]
    slots = group_slots(prog)
    for g, mine in enumerate(slots):
        assert all(mine.isdisjoint(other) for h, other in enumerate(slots)
                   if h != g)
    rows = np.random.default_rng(9).integers(0, 256, (prog.C, 48),
                                             dtype=np.uint8)
    want = kern.xor_schedule_plain(prog, torch.from_numpy(rows)).numpy()
    assert np.array_equal(run_encoded(prog, rows), want)


@pytest.mark.parametrize("name", GROUPED)
def test_groups_read_only_their_own_temps(name):
    """A group's steps compute exactly the temps of its rows' closure over
    ops, and read no temp slot but the ones it writes itself."""
    bm = matrices()[name]
    ops, outs, _ = port.xor_schedule_program(bm, cse=True)
    C = bm.shape[1]
    prog = kern.Program(ops, outs, C)
    need = kern.row_closures(ops, outs, C)
    zero = prog.n_vals - 2
    for g, rows in enumerate(prog.rows):
        closure = 0
        for r in rows:
            closure |= need[r]
        steps = prog.code[prog.offsets[g]:prog.offsets[g + 1]].tolist()
        temp_steps = [s for s in steps if s[3] == 0 and s[2] != zero + 1]
        assert len(temp_steps) == closure.bit_count()
        mine = group_slots(prog)[g]
        for a, b, _, _ in steps:
            for v in (a, b):
                assert v < C or v == zero or v in mine


@pytest.mark.parametrize("name", GROUPED)
def test_no_step_reads_the_temp_its_predecessor_wrote(name):
    """Inside each group, the kernel's read-ahead rule holds: no step reads
    a value that one of the PREFETCH steps before it in the same group
    wrote."""
    prog = program(name)
    dummy = prog.n_vals - 1
    for g in range(prog.groups):
        steps = prog.code[prog.offsets[g]:prog.offsets[g + 1]].tolist()
        for q, step in enumerate(steps):
            for prev in steps[max(0, q - kern.PREFETCH):q]:
                assert prev[2] == dummy or prev[2] not in step[:2]


def test_partition_balances_by_cost_not_by_neighbours():
    """The [64, 64] cauchy_good decode has 40 identity rows: cut into runs
    of neighbouring rows its longest group is far longer than the balanced
    partition's, which stays near an even share of the grouped steps."""
    bm = matrices()["cauchy_decode3"]
    ops, outs, _ = port.xor_schedule_program(bm, cse=True)
    prog = kern.Program(ops, outs, 64, groups=4)
    lengths = np.diff(prog.offsets)
    need = kern.row_closures(ops, outs, 64)

    def cost(rows):
        closure = 0
        for r in rows:
            closure |= need[r]
        return closure.bit_count() + sum(max(1, (len(outs[r]) + 1) // 2)
                                         for r in rows)

    runs = max(cost(range(q * 16, q * 16 + 16)) for q in range(4))
    assert prog.steps == lengths.max() < 0.8 * runs
    assert prog.steps <= 1.3 * lengths.sum() / 4
    single = kern.Program(ops, outs, 64, groups=1)
    assert prog.steps < 0.5 * single.steps


def test_k20m6_blocks_fit_in_shared_memory():
    """The widest profile the tests run, k=20 m=6, fits one K3 block of 4-byte
    elements and one K4 block at the default number of groups."""
    for cse in (True, False):
        prog = program("k20m6", cse)
        assert prog.groups == kern.GROUPS
        assert kern.apply_packedbit_smem(prog, kern.COLS) <= kern.MAX_SMEM
        assert kern.xor_schedule_smem(prog, kern.COLS, 4) <= kern.MAX_SMEM


def test_block_threads_and_routes():
    """Blocks and element widths at the main path's shapes: a block is 32
    lanes and one warp for each group.  K4 gives a lane two plane words,
    and K3 the widest element, where the grid still puts
    TARGET_WARPS_PER_SM warps on each SM of 132: two words (64 word columns
    a block) for a 4 MiB object, 16-byte elements on its 64 KiB packet
    rows, narrower ones for small operands."""
    prog = program("rs_encode")
    assert prog.groups == kern.GROUPS
    W = (4 << 20) // 8 // 32
    assert kern.apply_packedbit_words(prog, W, 132) == 2
    assert kern.warps_per_sm(prog, W // 2, 132) == 256 * kern.GROUPS / 132
    assert kern.apply_packedbit_words(prog, 1024, 132) == 1
    cauchy = program("cauchy_good")
    assert kern.xor_schedule_route(cauchy, 65536, 0, 256, 132) == "v16"
    assert kern.xor_schedule_route(cauchy, 1 << 18, 0, 256, 132) == "v16"
    assert kern.xor_schedule_route(cauchy, 16384, 0, 256, 132) == "v4"
    assert kern.xor_schedule_route(cauchy, 1000, 0, 256, 132) == "v4"
    assert kern.xor_schedule_route(cauchy, 4096, 3, 256, 132) == "b1"
    big = program("k20m6", cse=False)
    big.n_vals = kern.MAX_SMEM  # no element width fits
    assert kern.xor_schedule_route(big, 4096, 0, 256, 132) is None
    assert kern.apply_packedbit_words(big, W, 132) is None


def test_wrappers_refuse_what_the_kernels_do_not_take():
    prog = program("rs_encode")
    with pytest.raises(ValueError, match="rows for a program of 64"):
        kern.xor_schedule(prog, torch.zeros((63, 8), dtype=torch.uint8))
    with pytest.raises(ValueError, match="int32 or uint8"):
        kern.xor_schedule(prog, torch.zeros((64, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="program for 4 chunks"):
        kern.apply_packedbit(prog, torch.zeros((4, 32), dtype=torch.uint8))
    with pytest.raises(ValueError, match="planes for 2 rows"):
        kern.from_packedbit(torch.zeros((8, 4), dtype=torch.int32), 2)
