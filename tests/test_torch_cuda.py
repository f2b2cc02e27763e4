"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports nothing of JAX or ceph_tpu, so it runs where only the port does:

    python -m pytest tests/test_torch_cuda.py -q     # on a machine with a card

Where CUDA is absent every test here skips."""

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.matrices import (cauchy_good_matrix, invert_bitmatrix,
                                        matrix_to_bitmatrix,
                                        vandermonde_coding_matrix)
from ceph_tpu_torch.ec.plugins.cuda import CudaPlugin
from ceph_tpu_torch.ec.plugins.jerasure import JerasurePlugin
from ceph_tpu_torch.ops import cuda_gf2, cuda_packedbit
from ceph_tpu_torch.ops import gf2 as port_gf2
from ceph_tpu_torch.ops.slab import PageTable, new_subslab
from ceph_tpu_torch.parallel.service import BatchingQueue
from ceph_tpu_torch.rados import ecutil
from ceph_tpu_torch.rados.pagestore import PagedResidentStore

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def on(card, a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(card)


def test_apply_bytes_w8_matches_plain(card):
    """Both K1 routes, the wrapper's choice and the popc route, against the
    plain version: k=8 with every parity count the xor route takes, ragged
    and misaligned B, and wider k."""
    rng = np.random.default_rng(5)
    for out_rows in (1, 2, 3, 4):
        bm = on(card, rng.integers(-128, 128, size=(out_rows * 8, 64),
                                   dtype=np.int8))
        for B in (1, 3, 31, 1000, 4096, 32768 + 17, 524288):
            flat = on(card, rng.integers(0, 256, size=8 * B + 1, dtype=np.uint8))
            for data in (flat[:8 * B].view(8, B), flat[1:].view(8, B)):
                want = cuda_gf2.apply_bytes_w8_plain(bm, data)
                assert torch.equal(cuda_gf2.apply_bytes_w8(bm, data), want)
                assert torch.equal(cuda_gf2.apply_bytes_w8_popc(bm, data), want)
    for k, m, B in ((12, 4, 1001), (16, 4, 4096), (40, 2, 300)):
        bm = on(card, rng.integers(0, 2, size=(m * 8, k * 8), dtype=np.int8))
        data = on(card, rng.integers(0, 256, size=(k, B), dtype=np.uint8))
        want = cuda_gf2.apply_bytes_w8_plain(bm, data)
        assert torch.equal(cuda_gf2.apply_bytes_w8(bm, data), want)
        assert torch.equal(cuda_gf2.apply_bytes_w8_popc(bm, data), want)
    torch.cuda.synchronize()


def test_apply_bytes_w8_route_mirror_matches_the_entry(card):
    """apply_bytes_w8_route names the route ctt_apply_bytes_w8 takes, and
    the wrapper counts the launch under it."""
    lib = cuda_gf2._lib()
    rng = np.random.default_rng(9)
    for k, m in ((8, 3), (8, 4), (16, 1), (12, 4), (17, 3), (8, 5), (40, 2)):
        bm = on(card, rng.integers(0, 2, size=(m * 8, k * 8), dtype=np.int8))
        for B, offset in ((4096, 0), (4096, 1), (1000, 0), (1002, 2)):
            flat = on(card, rng.integers(0, 256, size=k * B + offset,
                                         dtype=np.uint8))
            data = flat[offset:].view(k, B)
            before = dict(cuda_gf2.apply_bytes_w8.routes)
            out = cuda_gf2.apply_bytes_w8(bm, data)
            route = cuda_gf2.apply_bytes_w8_route(
                k, m, B, bm.data_ptr(), data.data_ptr(), out.data_ptr())
            code = lib.ctt_apply_bytes_w8_route(
                bm.data_ptr(), data.data_ptr(), out.data_ptr(), k, m, B)
            assert cuda_gf2.K1_ROUTES[code] == route
            assert cuda_gf2.apply_bytes_w8.routes[route] == before[route] + 1


def test_gf2_matmul_matches_plain(card):
    """Both K2 routes, the wrapper's choice and the popc route, against the
    plain version: int8 operands with negatives, the main path's shapes,
    zero-padded R and C, ragged and misaligned B, and shapes past the mma
    route's limits."""
    rng = np.random.default_rng(6)
    for R, C, B in ((24, 64, 4096), (64, 64, 32768 + 16), (48, 128, 1001),
                    (48, 128, 4112), (64, 128, 16), (5, 40, 1040),
                    (17, 100, 300), (5, 200, 300), (7, 600, 77)):
        M = on(card, rng.integers(-128, 128, size=(R, C), dtype=np.int8))
        flat = on(card, rng.integers(-128, 128, size=C * B + 16,
                                     dtype=np.int8))
        for bits in (flat[:C * B].view(C, B), flat[1:C * B + 1].view(C, B),
                     flat[16:].view(C, B)):
            want = cuda_gf2.gf2_matmul_plain(M, bits)
            assert torch.equal(cuda_gf2.gf2_matmul(M, bits), want)
            assert torch.equal(cuda_gf2.gf2_matmul_popc(M, bits), want)
    torch.cuda.synchronize()


def test_gf2_matmul_route_mirror_matches_the_entry(card):
    """gf2_matmul_route names the route ctt_gf2_matmul takes, and the
    wrapper counts the launch under it."""
    lib = cuda_gf2._lib()
    rng = np.random.default_rng(10)
    for R, C in ((24, 64), (64, 64), (48, 128), (65, 64), (24, 129), (3, 7)):
        M = on(card, rng.integers(0, 2, size=(R, C), dtype=np.int8))
        for B, offset in ((4096, 0), (4096, 16), (4096, 4), (4096, 1),
                          (1000, 0), (1002, 0)):
            flat = on(card, rng.integers(0, 2, size=C * B + offset,
                                         dtype=np.int8))
            bits = flat[offset:].view(C, B)
            before = dict(cuda_gf2.gf2_matmul.routes)
            out = cuda_gf2.gf2_matmul(M, bits)
            route = cuda_gf2.gf2_matmul_route(R, C, B, bits.data_ptr(),
                                              out.data_ptr())
            code = lib.ctt_gf2_matmul_route(bits.data_ptr(), out.data_ptr(),
                                            R, C, B)
            assert cuda_gf2.K2_ROUTES[code] == route
            assert cuda_gf2.gf2_matmul.routes[route] == before[route] + 1
    torch.cuda.synchronize()


def _lane_launches() -> int:
    """Launches of every kernel a codec seam can reach: K1 and K2 of the
    int8-plane lane, K3 and K4 of the packed-bit lane."""
    return (cuda_gf2.apply_bytes_w8.launches + cuda_gf2.gf2_matmul.launches
            + cuda_packedbit.xor_schedule.launches
            + cuda_packedbit.apply_packedbit.launches)


@pytest.mark.parametrize("profile", [
    dict(technique="reed_sol_van", k="8", m="3"),
    dict(technique="reed_sol_van", k="4", m="2", w="16"),
    dict(technique="cauchy_good", k="8", m="3", packetsize="64"),
])
def test_cuda_plugin_matches_cpu_jerasure(card, profile):
    cuda = CudaPlugin().factory(dict(profile, plugin="cuda"))
    cpu = JerasurePlugin().factory(dict(profile, plugin="jerasure"))
    assert cuda.device.type == "cuda"
    obj = np.random.default_rng(7).integers(0, 256, 1 << 18,
                                            dtype=np.uint8).tobytes()
    n = cuda.get_chunk_count()
    launches = _lane_launches()
    ec, ej = cuda.encode(set(range(n)), obj), cpu.encode(set(range(n)), obj)
    assert _lane_launches() > launches
    for c in range(n):
        assert np.array_equal(ec[c], ej[c])
    lost = {0, n - 1}
    out = cuda.decode(lost, {c: ec[c] for c in ec if c not in lost}, len(ec[0]))
    for c in lost:
        assert np.array_equal(out[c], ec[c])


def test_cauchy_good_bitmatrix_kernel_matches_plain(card):
    bm = on(card, matrix_to_bitmatrix(cauchy_good_matrix(8, 3, 8), 8)
            .astype(np.int8))
    bits = on(card, np.random.default_rng(8).integers(
        0, 2, size=(64, 1 << 16), dtype=np.int8))
    assert torch.equal(cuda_gf2.gf2_matmul(bm, bits),
                       cuda_gf2.gf2_matmul_plain(bm, bits))


def _program(bm: np.ndarray, cse: bool = True) -> cuda_packedbit.Program:
    ops, outs, _ = port_gf2.xor_schedule_program(bm, cse=cse)
    return cuda_packedbit.Program(ops, outs, bm.shape[1])


def _rs_bitmatrix(k: int, m: int) -> np.ndarray:
    return matrix_to_bitmatrix(vandermonde_coding_matrix(k, m, 8), 8)


def _cauchy_good_decode3() -> np.ndarray:
    """The [64, 64] cauchy_good k=8 m=3 decode when chunks 1, 5 and 9 are
    lost: the inverse of the chosen chunks' rows of data ‖ coding."""
    full = np.vstack([np.eye(64, dtype=np.uint8),
                      matrix_to_bitmatrix(cauchy_good_matrix(8, 3, 8), 8)])
    chosen = [c for c in range(11) if c not in (1, 5, 9)][:8]
    return invert_bitmatrix(np.vstack([full[c * 8:(c + 1) * 8] for c in chosen]))


def test_xor_schedule_matches_plain(card):
    """K3 on int32 plane words and uint8 packet rows, on every element
    width: aligned, ragged and misaligned rows, extra operand rows, an
    all-zero output row, a program without CSE, the cauchy_good encode and
    3-erasure decode, and k=20 m=6."""
    rng = np.random.default_rng(11)
    bm = _rs_bitmatrix(8, 3)
    zero_row = bm.copy()
    zero_row[5] = 0
    cases = [(_program(bm), 64), (_program(bm, cse=False), 64),
             (_program(zero_row), 64),
             (_program(matrix_to_bitmatrix(cauchy_good_matrix(8, 3, 8), 8)), 64),
             (_program(_cauchy_good_decode3()), 64),
             (_program(_rs_bitmatrix(20, 6)), 160)]
    for prog, C in cases:
        for dtype, N, offset in ((np.int32, 4096, 0), (np.int32, 1001, 1),
                                 (np.uint8, 65536, 0), (np.uint8, 1000, 0),
                                 (np.uint8, 31, 3), (np.uint8, 1, 0)):
            info = np.iinfo(dtype)
            flat = on(card, rng.integers(info.min, info.max, (C + 2) * N
                                         + offset, dtype=dtype))
            rows = flat[offset:].view(C + 2, N)
            want = cuda_packedbit.xor_schedule_plain(prog, rows)
            assert torch.equal(cuda_packedbit.xor_schedule(prog, rows), want)
    torch.cuda.synchronize()


def test_packedbit_transposes_and_apply_match_plain(card):
    """K4 (both forms), K5 and K6 against their plain versions at ragged B,
    a misaligned base and the main path's width."""
    rng = np.random.default_rng(12)
    progs = [(_program(_rs_bitmatrix(8, 3)), 8), (_program(_rs_bitmatrix(20, 6)), 20)]
    for prog, k in progs:
        for B, offset in ((1, 0), (31, 0), (1000, 0), (4096, 1), (4096, 0),
                          (524288, 0)):
            flat = on(card, rng.integers(0, 256, k * B + offset, dtype=np.uint8))
            data = flat[offset:].view(k, B)
            planes = cuda_packedbit.to_packedbit(data)
            assert torch.equal(planes, cuda_packedbit.to_packedbit_plain(data))
            assert torch.equal(cuda_packedbit.from_packedbit(planes, k),
                               cuda_packedbit.from_packedbit_plain(planes, k))
            want = cuda_packedbit.apply_packedbit_plain(prog, data, True)
            assert torch.equal(cuda_packedbit.apply_packedbit(prog, data),
                               want[0])
            got = cuda_packedbit.apply_packedbit(prog, data, resident=True)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()


@pytest.mark.parametrize("groups", [1, 3, 8])
def test_grouped_blocks_match_plain(card, groups):
    """K3 on every element width and K4 with 1 and 2 plane words a lane,
    for programs split into 1, 3 and 8 groups of output rows (blocks of
    32 * groups threads): ragged, misaligned and main-path widths, a
    zero output row, k=20 m=6 and the [64, 64] cauchy_good decode."""
    rng = np.random.default_rng(14 + groups)
    zero_row = _rs_bitmatrix(8, 3)
    zero_row[5] = 0
    for bm in (_rs_bitmatrix(8, 3), zero_row, _rs_bitmatrix(20, 6),
               _cauchy_good_decode3()):  # wide lanes that do not fit are skipped
        ops, outs, _ = port_gf2.xor_schedule_program(bm)
        prog = cuda_packedbit.Program(ops, outs, bm.shape[1], groups=groups)
        C = bm.shape[1]
        for N, offset in ((65536, 0), (4096, 4), (1001, 1), (31, 0)):
            flat = on(card, rng.integers(0, 256, C * N + offset, dtype=np.uint8))
            rows = flat[offset:].view(C, N)
            want = cuda_packedbit.xor_schedule_plain(prog, rows)
            for route in ("v16", "v4", "b1"):
                vec = {"v16": 16, "v4": 4, "b1": 1}[route]
                if (N % vec == 0 and offset % vec == 0
                        and cuda_packedbit.xor_schedule_smem(prog, 32, vec)
                        <= cuda_packedbit.MAX_SMEM):
                    got = cuda_packedbit.xor_schedule(prog, rows, route)
                    assert torch.equal(got, want), (route, N, offset)
        if C % 8 or prog.R % 8:
            continue
        k = C // 8
        for B, offset in ((524288, 0), (32768 + 17, 0), (4096, 1), (1000, 0)):
            flat = on(card, rng.integers(0, 256, k * B + offset, dtype=np.uint8))
            data = flat[offset:].view(k, B)
            want = cuda_packedbit.apply_packedbit_plain(prog, data, True)
            for words in (1, 2):
                if (cuda_packedbit.apply_packedbit_smem(prog, 32 * words)
                        > cuda_packedbit.MAX_SMEM):
                    continue
                got = cuda_packedbit.apply_packedbit(prog, data, True, words)
                assert torch.equal(got[0], want[0]) and torch.equal(
                    got[1], want[1]), (words, B, offset)
                assert torch.equal(
                    cuda_packedbit.apply_packedbit(prog, data, words=words),
                    want[0])
    torch.cuda.synchronize()


@pytest.mark.parametrize("packedbit", ["1", "0"])
@pytest.mark.parametrize("profile", [
    dict(technique="reed_sol_van", k="8", m="3"),
    dict(technique="cauchy_good", k="8", m="3", packetsize="2048"),
])
def test_seam_identity_with_lane_on_and_off(card, monkeypatch, packedbit,
                                            profile):
    """plugin=cuda chunks equal CPU plugin=jerasure's with the packed-bit lane
    on and off, and the lane's kernels launch only when it is on."""
    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", packedbit)
    cuda = CudaPlugin().factory(dict(profile, plugin="cuda"))
    cpu = JerasurePlugin().factory(dict(profile, plugin="jerasure"))
    obj = np.random.default_rng(13).integers(0, 256, 1 << 20,
                                             dtype=np.uint8).tobytes()
    lane = (cuda_packedbit.xor_schedule.launches
            + cuda_packedbit.apply_packedbit.launches)
    ec, ej = cuda.encode(set(range(11)), obj), cpu.encode(set(range(11)), obj)
    out = cuda.decode({1, 5, 9}, {c: ec[c] for c in ec if c not in (1, 5, 9)},
                      len(ec[0]))
    launched = (cuda_packedbit.xor_schedule.launches
                + cuda_packedbit.apply_packedbit.launches) - lane
    assert (launched > 0) == (packedbit == "1")
    for c in range(11):
        assert np.array_equal(ec[c], ej[c])
    for c in (1, 5, 9):
        assert np.array_equal(out[c], ej[c])


def test_queue_matches_cpu_queue_and_waits_for_its_rounds(card):
    """Concurrent 1 MiB writes and a degraded read through a CUDA queue
    (two objects a round, so rounds overlap) equal the CPU queue's, and no
    future resolves before the `done` event of its round has completed."""
    codec = JerasurePlugin().factory(dict(technique="reed_sol_van", k="8",
                                          m="3", plugin="jerasure"))
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * 4096)
    rng = np.random.default_rng(17)
    bufs = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
            for _ in range(6)]
    lost = (1, 5, 9)

    async def drive(q):
        outs = await asyncio.gather(*(ecutil.batched_encode_async(
            codec, sinfo, b, queue=q) for b in bufs))
        read = await ecutil.decode_object_async(
            codec, sinfo, {c: s for c, s in enumerate(outs[0])
                           if c not in lost}, len(bufs[0]), queue=q)
        return outs, read

    gpu = BatchingQueue(device=card, max_pending_bytes=2 << 20)
    cpu = BatchingQueue(device="cpu")
    seen = []
    complete = gpu._complete_safe

    def watched(launched):
        for lc in launched:
            for req in lc.group.requests:
                req.future.add_done_callback(
                    lambda f, ev=lc.done: seen.append(ev.query()))
        complete(launched)

    gpu._complete_safe = watched
    try:
        g_outs, g_read = asyncio.run(asyncio.wait_for(drive(gpu), 120))
        c_outs, c_read = asyncio.run(asyncio.wait_for(drive(cpu), 120))
    finally:
        gpu.close()
        cpu.close()
    for g, c in zip(g_outs, c_outs):
        for a, b in zip(g, c):
            assert np.array_equal(a, b)
    assert g_read == c_read == bufs[0]
    assert len(seen) == len(bufs) + 1 and all(seen)
    assert gpu.dispatches >= 3 and gpu.perf.get("breaker_trip") == 0
    assert not gpu._worker.is_alive()


def test_queue_plane_lanes_match_cpu_queue(card):
    """The resident and plane lanes on the card equal the CPU queue's; one
    device input is written on a side stream and submitted from it, so the
    queue must wait for that stream."""
    rng = np.random.default_rng(19)
    bm = matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 8), 8)
    data = [rng.integers(0, 256, (8, B), dtype=np.uint8)
            for B in (4096, 8192)]
    side = torch.cuda.Stream()
    results = {}
    for dev in (card, torch.device("cpu")):
        q = BatchingQueue(device=dev, max_delay=0.01)
        try:
            planes = [port_gf2.to_packedbit(torch.from_numpy(d).to(dev))
                      for d in data]
            bits = [port_gf2.unpack_bits_bytes(torch.from_numpy(d).to(dev), 8)
                    for d in data]
            with torch.cuda.stream(side):
                torch.cuda._sleep(1_000_000)  # the copy lands late
                planes[0] = planes[0].clone()
                futs = [q.submit_packedbit_planes(bm.astype(np.uint8), p, 8,
                                                  3) for p in planes]
            futs += [q.submit_packedbit_resident(bm.astype(np.uint8), d, 8, 3)
                     for d in data]
            futs += [q.submit_resident(bm.astype(np.int8), d, 8, 3)
                     for d in data]
            futs += [q.submit_planar(bm.astype(np.int8), b, 8, 3)
                     for b in bits]
            results[dev.type] = [f.result(timeout=60) for f in futs]
        finally:
            q.close()

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    for g, c in zip(results["cuda"], results["cpu"]):
        g = g if isinstance(g, tuple) else (g,)
        c = c if isinstance(c, tuple) else (c,)
        for a, b in zip(g, c):
            assert np.array_equal(host(a), host(b))


@pytest.mark.parametrize("layout", ["eight_shards_of_one_card",
                                    "every_card"])
def test_queue_on_a_mesh_matches_one_device(card, monkeypatch, layout):
    """All six lanes through a queue on a mesh (8 shards of the card, or
    every visible card) equal a mesh=False queue's byte for byte; every
    dispatch is sharded, each shard one launch of the lane's kernel."""
    from ceph_tpu_torch.parallel.mesh import MeshDispatcher

    if layout == "every_card":
        if torch.cuda.device_count() < 2:
            pytest.skip("needs two or more cards")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [torch.device("cuda", torch.cuda.current_device())] * 8
    rng = np.random.default_rng(23)
    bm = matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 8), 8)
    data = [rng.integers(0, 256, (8, B), dtype=np.uint8)
            for B in (4096, 12288, 1000)]

    def drive(q, lane_off):
        out = []
        aligned = data[:2]  # the packed-bit resident lane takes whole words
        if lane_off:
            out += [q.submit(bm.astype(np.int8), d, 8, 3) for d in data]
            out += [q.submit_resident(bm.astype(np.int8), d, 8, 3)
                    for d in data]
            out += [q.submit_planar(
                bm.astype(np.int8),
                port_gf2.unpack_bits_bytes(torch.from_numpy(d).to(card), 8),
                8, 3) for d in data]
        else:
            out += [q.submit_packedbit(bm.astype(np.uint8), d, 8, 3)
                    for d in data]
            out += [q.submit_packedbit_resident(bm.astype(np.uint8), d, 8, 3)
                    for d in aligned]
            out += [q.submit_packedbit_planes(
                bm.astype(np.uint8),
                port_gf2.to_packedbit(torch.from_numpy(d).to(card)), 8, 3)
                for d in aligned]
        q.flush()
        return [f.result(timeout=60) for f in out]

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    for lane_off in (False, True):
        monkeypatch.setenv("CEPH_TPU_PACKEDBIT", "0" if lane_off else "1")
        mesh = MeshDispatcher(devices)
        on_mesh = BatchingQueue(device=card, max_delay=60.0, mesh=mesh)
        single = BatchingQueue(device=card, max_delay=60.0, mesh=False)
        try:
            kernels = ((cuda_gf2.apply_bytes_w8, cuda_gf2.gf2_matmul)
                       if lane_off else (cuda_packedbit.apply_packedbit,
                                         cuda_packedbit.xor_schedule))
            before = [fn.launches for fn in kernels]
            got = drive(on_mesh, lane_off)
            torch.cuda.synchronize()
            launched = [fn.launches - b for fn, b in zip(kernels, before)]
            want = drive(single, lane_off)
        finally:
            on_mesh.close()
            single.close()
        assert on_mesh.mesh is mesh and single.mesh is None
        assert on_mesh.sharded_dispatches == on_mesh.dispatches == 3
        assert mesh.shard_puts == 3
        # lane off: K1 for packed, K2 for resident and planar; lane on: K4
        # for packedbit and packedbit_resident, K3 for packedbit_planes
        assert launched == ([len(devices), 2 * len(devices)] if lane_off
                            else [2 * len(devices), len(devices)])
        for g, c in zip(got, want):
            g = g if isinstance(g, tuple) else (g,)
            c = c if isinstance(c, tuple) else (c,)
            for a, b in zip(g, c):
                if isinstance(a, torch.Tensor):
                    assert a.device == on_mesh.device == devices[0]
                assert np.array_equal(host(a), host(b))


def test_device_arm_store_on_the_card_matches_the_host_arm(card):
    """The paged store's device arm on CUDA sub-slabs against its host arm
    and against the device arm on CPU tensors: reads, partial gathers,
    eviction, a parity shed and a raw resident, with the same counters;
    the CUDA device arm never commits a host page."""
    rng = np.random.default_rng(23)
    stores = [PagedResidentStore(40 * 4096, page_bytes=4096, device=card),
              PagedResidentStore(40 * 4096, page_bytes=4096, device=card,
                                 device_arm=False),
              PagedResidentStore(40 * 4096, page_bytes=4096, device="cpu",
                                 device_arm=True)]
    assert [s.device_arm for s in stores] == [True, False, True]
    objs = [rng.integers(0, 256, (6, B), dtype=np.uint8)
            for B in (100, 3000, 4096, 4128, 12256, 13, 20000)]
    raw = rng.integers(0, 256, 9999, dtype=np.uint8).tobytes()
    logs = []
    for st in stores:
        log = []
        for i, rows in enumerate(objs):
            log.append(st.admit(f"o{i}", rows, layout="packedbit",
                                meta=(i,)))
            st.admit(f"t{i}", rows, layout="packedbit")
            log.append(st.put_planar(f"o{i}", st.peek(f"t{i}")[0], w=8,
                                     n_rows=6, meta=(i,), trim=rows.shape[1],
                                     data_rows=32))
        for i in range(len(objs)):
            got = st.read(f"o{i}")
            log.append(None if got is None else got.tobytes())
            g = st.gather_rows(f"o{i}", 3, 40)
            log.append(None if g is None else
                       np.asarray(g.cpu() if torch.is_tensor(g) else g)
                       .tobytes())
        log.append(st.shed_parity("o6"))
        log.append(st.gather_rows("o6", 0, 32) is not None)
        log.append((st.put_raw("r", raw), st.read_raw("r") == raw))
        stats = st.stats()
        for key in ("device_arm", "device_slabs", "h2d_installs",
                    "device_installs", "d2h_gathers"):
            stats.pop(key)
        log.append(stats)
        logs.append(log)
    assert logs[0] == logs[1] == logs[2]
    dev = stores[0]
    assert dev._slabs == [] and all(s.is_cuda for s in dev._dev_slabs
                                    if s is not None)
    assert dev.h2d_installs == 1  # the raw resident; every admit is native
    assert dev.device_installs == stores[2].device_installs
    torch.cuda.synchronize()


def test_install_of_a_queue_product_while_the_next_round_runs(card):
    """Resident writes through a CUDA queue, each product installed in a
    device-arm store from a side stream as it arrives while later rounds
    run, and read back on the default stream: every object equals its
    bytes, and no product crossed from the host."""
    codec = JerasurePlugin().factory(dict(technique="reed_sol_van", k="8",
                                          m="3", plugin="jerasure"))
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * 4096)
    rng = np.random.default_rng(29)
    bufs = [rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
            for _ in range(8)]
    q = BatchingQueue(device=card, max_pending_bytes=2 << 20)
    store = PagedResidentStore(64 << 20, page_bytes=64 << 10, queue=q,
                               device=card)
    side = torch.cuda.Stream()

    async def write(i):
        product = await ecutil.planar_encode_async(codec, sinfo, bufs[i],
                                                   queue=q)
        _, bits, n_rows, n_cols, w = product
        with torch.cuda.stream(side):
            assert store.put_planar(i, bits, w=w, n_rows=n_rows,
                                    meta=(1, n_cols, len(bufs[i])),
                                    trim=n_cols, data_rows=8 * w)
        return product

    async def drive():
        return await asyncio.gather(*(write(i) for i in range(len(bufs))))

    try:
        products = asyncio.run(asyncio.wait_for(drive(), 120))
    finally:
        q.close()
    for i, buf in enumerate(bufs):
        assert ecutil.planar_object_bytes(store, i, 1, 8, 4096,
                                          len(buf)) == buf
        rows = ecutil.planar_rows(store, i, 1)
        for a, b in zip(rows, products[i][0]):
            assert np.array_equal(a, np.asarray(b))
    assert store.device_installs == len(bufs) and store.h2d_installs == 0
    assert q.dispatches < len(bufs)
    torch.cuda.synchronize()


def _scattered_table(card, rng, page_words, n_pages):
    """n_pages of random words scattered over two CUDA sub-slabs in random
    order, and the same table over CPU copies of the sub-slabs."""
    host = {s: torch.from_numpy(rng.integers(
        -2 ** 31, 2 ** 31, (256, page_words), dtype=np.int64).astype(np.int32))
        for s in range(2)}
    pages = rng.permutation(512)[:n_pages]
    dev = {s: new_subslab(256, page_words, card) for s in host}
    for s, t in host.items():
        dev[s].copy_(t)
    return (PageTable(pages, dev, page_words, 8),
            PageTable(pages, host, page_words, 8))


@pytest.mark.parametrize("page_words,row_words,L,cs", [
    (16384, 16384, 524288, 4096),   # the OSD's object read
    (16384, 16384, 524288, 0),      # its shard rows
    (64, 15, 480, 160),             # rows straddling pages, mid-page start
    (64, 10, 300, 100),             # chunks that end mid-word
    (100, 7, 200, 0),               # pages that are not a power of two
    (16, 40, 1280, 128),            # a plane row longer than two pages
])
def test_from_packedbit_paged_matches_plain(card, page_words, row_words, L,
                                            cs):
    rng = np.random.default_rng(page_words + row_words + L)
    out_rows = 8
    w0 = 3 * row_words
    words = w0 + out_rows * 8 * row_words
    dev, host = _scattered_table(card, rng, page_words,
                                 -(-words // page_words))
    limits = (out_rows * L, out_rows * L - 333) if cs else (0,)
    for limit in limits:
        got = cuda_packedbit.from_packedbit_paged(dev, w0, row_words,
                                                  out_rows, L, cs, limit)
        want = cuda_packedbit.from_packedbit_paged(host, w0, row_words,
                                                   out_rows, L, cs, limit)
        assert torch.equal(got.cpu(), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,B,page_words", [
    (11, 524288, 16384),   # the OSD's admit: 88 whole pages
    (3, 1000, 64),         # a ragged last page
    (5, 4097, 100),        # misaligned rows, pages of 100 words
])
def test_to_packedbit_paged_matches_plain(card, n, B, page_words):
    rng = np.random.default_rng(n * B)
    words = n * 8 * -(-B // 32)
    dev, host = _scattered_table(card, rng, page_words,
                                 -(-words // page_words))
    data = rng.integers(0, 256, (n, B), dtype=np.uint8)
    cuda_packedbit.to_packedbit_paged(on(card, data), dev)
    cuda_packedbit.to_packedbit_paged(torch.from_numpy(data), host)
    for s in range(2):
        assert torch.equal(dev.slabs[s].cpu(), host.slabs[s])
    torch.cuda.synchronize()


def test_cluster_on_the_card_reads_back_and_degrades(card, monkeypatch):
    """A small plugin=cuda k=4 m=2 cluster on the card (the default
    osd_ec_device): put, get and a degraded get equal the data, and the
    shared queue and resident store run on CUDA."""
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados.vstart import Cluster

    monkeypatch.setattr(osdmod, "_BATCH_QUEUE", None)
    monkeypatch.setattr(osdmod, "_PLANAR_STORE", None)
    rng = np.random.default_rng(11)
    objects = {f"o{n}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in (10, 100_000, 1 << 20)}

    async def go():
        cluster = Cluster(n_osds=7, conf={"mon_osd_report_grace": 0.8,
                                          "osd_heartbeat_interval": 0.2,
                                          "client_op_timeout": 30.0})
        await cluster.start()
        c = await cluster.client()
        try:
            pool = await c.create_pool("cu", "ec", pg_num=4, profile={
                "plugin": "cuda", "technique": "reed_sol_van",
                "k": "4", "m": "2"})
            for oid, data in objects.items():
                await c.put(pool, oid, data)
            reads = [await c.get(pool, oid) for oid in objects]
            p = c.osdmap.pools[pool]
            acting = c.osdmap.pg_to_acting(p, c.osdmap.object_to_pg(p, "o10"))
            for victim in [a for a in acting if a != CRUSH_ITEM_NONE][:2]:
                await cluster.kill_osd(victim)
                await c.mark_osd_down(victim)
            degraded = [await c.get(pool, oid) for oid in objects]
            return reads, degraded
        finally:
            await c.stop()
            await cluster.stop()

    try:
        reads, degraded = asyncio.run(asyncio.wait_for(go(), 120))
        want = list(objects.values())
        assert reads == want and degraded == want
        assert osdmod._BATCH_QUEUE.device.type == "cuda"
        assert osdmod._PLANAR_STORE.device.type == "cuda"
        assert osdmod._PLANAR_STORE.device_arm
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()


def test_lrc_and_clay_on_cuda_equal_their_jerasure_twins(card):
    """lrc with three plugin=cuda layers and clay with scalar_mds=cuda, built
    on the card through the registry: chunks, a degraded decode and clay's
    sub-chunk repair equal the jerasure-layered CPU codecs', and each
    codec's work launches K4 (apply_packedbit)."""
    import json

    from ceph_tpu_torch.ec.registry import registry

    def layers(plugin):
        return json.dumps([[c, f"plugin={plugin} technique=reed_sol_van"]
                           for c in ("DDc_DDc_", "DDDc____", "____DDDc")])

    pairs = [
        ({"plugin": "lrc", "mapping": "DD__DD__", "layers": layers("cuda")},
         {"plugin": "lrc", "mapping": "DD__DD__", "layers": layers("jerasure")},
         [(0,), (2, 5)]),
        ({"plugin": "clay", "k": "8", "m": "4", "d": "11", "scalar_mds": "cuda"},
         {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
         [(3,), (0, 11)]),
    ]
    data = np.random.default_rng(12).integers(0, 256, 1 << 20,
                                              dtype=np.uint8).tobytes()
    for profile, twin_profile, erasures in pairs:
        codec = registry.factory(profile["plugin"], "", dict(profile),
                                 device=card)
        twin = registry.factory(twin_profile["plugin"], "", dict(twin_profile))
        n = codec.get_chunk_count()
        cuda_packedbit.apply_packedbit.launches = 0
        got = codec.encode(set(range(n)), data)
        assert cuda_packedbit.apply_packedbit.launches > 0, profile["plugin"]
        want = twin.encode(set(range(n)), data)
        for c in range(n):
            assert np.array_equal(got[c], want[c]), (profile["plugin"], c)
        for erased in erasures:
            avail = {c: want[c] for c in range(n) if c not in erased}
            out = codec.decode(set(erased), avail, len(want[0]))
            for c in erased:
                assert np.array_equal(out[c], want[c]), (erased, c)


def test_isa_pool_on_the_card_writes_residents_and_reads_them(card,
                                                               monkeypatch):
    """A plugin=isa k=4 m=2 pool on the card: its writes take the queue's
    packed-bit resident lane (K4) and install residents, its reads come
    from them through the paged K6, and every stored shard equals the CPU
    isa codec's."""
    from ceph_tpu_torch.ec.registry import registry
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.vstart import Cluster

    monkeypatch.setattr(osdmod, "_BATCH_QUEUE", None)
    monkeypatch.setattr(osdmod, "_PLANAR_STORE", None)
    profile = {"plugin": "isa", "technique": "reed_sol_van", "k": "4", "m": "2"}
    cpu = registry.factory("isa", "", dict(profile))
    rng = np.random.default_rng(13)
    objects = {f"i{n}": rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for n in (4096, 100_000, 1 << 20)}

    async def go():
        cluster = Cluster(n_osds=6, conf={"client_op_timeout": 30.0,
                                          "osd_auto_repair": False})
        await cluster.start()
        c = await cluster.client()
        try:
            pool = await c.create_pool("isa", "ec", pg_num=4,
                                       profile=dict(profile))
            for oid, data in objects.items():
                await c.put(pool, oid, data)
            store = osdmod._PLANAR_STORE
            with store._lock:  # reads must gather from the pages
                for key in list(store._memo):
                    store._memo_discard(key)
            hits0 = sum(o.perf.get("planar_read_hits")
                        for o in cluster.osds.values())
            reads = [await c.get(pool, oid) for oid in objects]
            hits = sum(o.perf.get("planar_read_hits")
                       for o in cluster.osds.values()) - hits0
            osd0 = next(iter(cluster.osds.values()))
            sinfo = osd0._sinfo(c.osdmap.pools[pool])
            for oid, data in objects.items():
                want = ecutil.batched_encode(cpu, sinfo, data)
                for o in cluster.osds.values():
                    for s in range(6):
                        got = o.store.read((pool, oid, s))
                        if got is not None:
                            assert bytes(got[0]) == bytes(want[s]), (oid, s)
            return reads, hits
        finally:
            await c.stop()
            await cluster.stop()

    launches = cuda_packedbit.apply_packedbit, cuda_packedbit.from_packedbit_paged
    for fn in launches:
        fn.launches = 0
    try:
        reads, hits = asyncio.run(asyncio.wait_for(go(), 120))
        assert reads == list(objects.values())
        assert hits > 0
        assert all(fn.launches > 0 for fn in launches)
        assert osdmod._PLANAR_STORE.device.type == "cuda"
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()


def test_rbd_image_on_the_card_reaches_the_mgr(card, monkeypatch):
    """An rbd image on a plugin=cuda k=4 m=2 pool with the mgr: whole-object
    writes encode on the card (K4), a partial write re-encodes through the
    OSD's RMW, reads come from residents through the paged K6, and the
    OSDs' ec_cuda counters reach the mgr's /metrics."""
    import time

    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.rados.vstart import Cluster
    from ceph_tpu_torch.services.rbd import RBD

    monkeypatch.setattr(osdmod, "_BATCH_QUEUE", None)
    monkeypatch.setattr(osdmod, "_PLANAR_STORE", None)
    order, n_objects = 20, 4
    size = n_objects << order
    rng = np.random.default_rng(17)
    model = bytearray(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    patch = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    conf = {"client_op_timeout": 30.0, "osd_auto_repair": False,
            "osd_heartbeat_interval": 0.1}

    async def go():
        cluster = Cluster(n_osds=6, conf=dict(conf), with_mgr=True)
        await cluster.start()
        rados = await Rados(cluster.mon_addrs, dict(conf)).connect()
        try:
            await rados.pool_create("rbd", pg_num=4, profile={
                "plugin": "cuda", "technique": "reed_sol_van",
                "k": "4", "m": "2"})
            img = await RBD(await rados.open_ioctx("rbd")).create(
                "disk", size, order=order)
            await img.write(0, bytes(model))
            await img.write(5000, patch)
            model[5000:5000 + len(patch)] = patch
            got = await img.read(0, size)
            rmw = sum(o.perf.get("rmw_partial")
                      for o in cluster.osds.values())
            mgr, t_last = cluster.mgr, time.time()
            names = [f"osd.{i}" for i in cluster.osds]
            for _ in range(100):
                if all(n in mgr.reports and mgr.reports[n].stamp > t_last
                       for n in names):
                    break
                await asyncio.sleep(0.05)
            return got, rmw, mgr.prometheus_text(), names
        finally:
            await rados.shutdown()
            await cluster.stop()

    launches = cuda_packedbit.apply_packedbit, cuda_packedbit.from_packedbit_paged
    for fn in launches:
        fn.launches = 0
    try:
        got, rmw, text, names = asyncio.run(asyncio.wait_for(go(), 120))
        assert got == bytes(model)
        assert rmw == 1
        assert all(fn.launches > 0 for fn in launches)
        dispatch = osdmod._BATCH_QUEUE.perf.get("dispatch")
        for name in names:
            assert f'ceph_ec_cuda_dispatch{{daemon="{name}"}} {dispatch}' \
                in text.splitlines()
        assert osdmod._PLANAR_STORE.device.type == "cuda"
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()


def test_rgw_and_cephfs_on_the_card_equal_their_jerasure_twin(card,
                                                              monkeypatch):
    """S3 objects of 4 MiB (rgw's stripe) and one CephFS file on a
    plugin=cuda k=4 m=2 pool on the card, and the same script on a CPU
    plugin=jerasure twin pool of the same cluster: every read equals the
    data, both pools hold the same objects with the same bytes, each
    OSD's shard of an EC object on the card equals the jerasure codec's,
    and the card's writes launch K4 and its resident reads the paged K6."""
    import types

    from ceph_tpu_torch.ec.registry import registry
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.rados.vstart import Cluster
    from ceph_tpu_torch.services import mds, rgw

    monkeypatch.setattr(osdmod, "_BATCH_QUEUE", None)
    monkeypatch.setattr(osdmod, "_PLANAR_STORE", None)
    ids = iter(range(1 << 30))
    monkeypatch.setattr(mds, "uuid", types.SimpleNamespace(
        uuid4=lambda: types.SimpleNamespace(hex=f"{next(ids):032x}")))
    monkeypatch.setattr(mds, "time", types.SimpleNamespace(time=lambda: 0.0))
    monkeypatch.setattr(rgw, "time", types.SimpleNamespace(time=lambda: 0.0))
    stripe = 4 << 20
    rng = np.random.default_rng(19)
    objects = {f"o{i}": rng.integers(0, 256, stripe, dtype=np.uint8)
               .tobytes() for i in range(2)}
    file_bytes = rng.integers(0, 256, stripe + 4096,
                              dtype=np.uint8).tobytes()
    profiles = {"cu": "cuda", "jer": "jerasure"}
    conf = {"client_op_timeout": 30.0, "osd_auto_repair": False}

    async def script(ioctx):
        svc = rgw.RgwService(ioctx, chunk_size=stripe)
        await svc.create_bucket("b")
        for key, data in objects.items():
            await svc.put_object("b", key, data)
        fs = mds.FileSystem(ioctx)
        await fs.mkfs()
        await fs.mkdir("/d")
        await fs.write_file("/d/f", file_bytes)
        return ([await svc.get_object("b", key) for key in objects],
                await fs.read_file("/d/f"))

    async def go():
        cluster = Cluster(n_osds=6, conf=dict(conf))
        await cluster.start()
        rados = await Rados(cluster.mon_addrs, dict(conf)).connect()
        try:
            out = {}
            for pool, plugin in profiles.items():
                await rados.pool_create(pool, pg_num=4, profile={
                    "plugin": plugin, "technique": "reed_sol_van",
                    "k": "4", "m": "2"})
                ioctx = await rados.open_ioctx(pool)
                nonlocal ids
                ids = iter(range(1 << 30))
                reads = await script(ioctx)
                names = sorted(await ioctx.list_objects())
                out[pool] = (reads, {n: await ioctx.read(n) for n in names},
                             ioctx.pool_id)
            osd0 = next(iter(cluster.osds.values()))
            sinfo = osd0._sinfo(rados._client.osdmap.pools[out["cu"][2]])
            shards = {}
            for oid in out["cu"][1]:
                for o in cluster.osds.values():
                    for s in range(6):
                        got = o.store.read((out["cu"][2], oid, s))
                        if got is not None:
                            shards[(oid, s)] = bytes(got[0])
            return out, sinfo, shards
        finally:
            await rados.shutdown()
            await cluster.stop()

    launches = cuda_packedbit.apply_packedbit, cuda_packedbit.from_packedbit_paged
    for fn in launches:
        fn.launches = 0
    try:
        out, sinfo, shards = asyncio.run(asyncio.wait_for(go(), 180))
        for pool in profiles:
            reads, files = out[pool][0]
            assert reads == list(objects.values()) and files == file_bytes
        assert out["cu"][1] == out["jer"][1]
        cpu = registry.factory("jerasure", "", {
            "plugin": "jerasure", "technique": "reed_sol_van",
            "k": "4", "m": "2"})
        assert shards
        for (oid, s), got in shards.items():
            want = ecutil.batched_encode(cpu, sinfo, out["cu"][1][oid])
            assert got == bytes(want[s]), (oid, s)
        assert all(fn.launches > 0 for fn in launches)
        assert osdmod._PLANAR_STORE.device.type == "cuda"
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()


def _tpu_archive_args():
    import os

    corpus = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "corpus")
    (archive,) = [d for d in os.listdir(corpus) if d.startswith("plugin=tpu")]
    parts = archive.split()
    argv = ["--base", corpus, "--stripe-width", parts[1].split("=", 1)[1]]
    for kv in parts[2:]:
        argv += ["-P", kv]
    return argv


@pytest.mark.parametrize("packedbit,kernel", [
    ("1", cuda_packedbit.apply_packedbit), ("0", cuda_gf2.apply_bytes_w8)])
def test_non_regression_replays_the_tpu_archive_on_the_card(
        card, monkeypatch, packedbit, kernel):
    """`non_regression --check --plugin cuda` of the plugin=tpu archive on
    the card: K4 with the packed-bit lane on, K1 with it off."""
    from ceph_tpu_torch.tools import non_regression

    monkeypatch.setenv("CEPH_TPU_PACKEDBIT", packedbit)
    before = kernel.launches
    assert non_regression.main(["--check", "--plugin", "cuda", "--device",
                                "cuda"] + _tpu_archive_args()) == 0
    torch.cuda.synchronize()
    assert kernel.launches > before


@pytest.mark.parametrize("technique,kernel", [
    ("reed_sol_van", cuda_packedbit.apply_packedbit),
    ("cauchy_good", cuda_packedbit.xor_schedule)])
def test_bench_suite_cell_of_cuda_runs_its_kernel(card, capsys, technique,
                                                  kernel):
    """One bench_suite cell of plugin=cuda on the card: K4 for
    reed_sol_van, K3 for cauchy_good."""
    import json

    from ceph_tpu_torch.tools import bench_suite

    saved = dict(bench_suite.TECHNIQUES)
    bench_suite.TECHNIQUES["cuda"] = [technique]
    before = kernel.launches
    try:
        assert bench_suite.main(["--plugins", "cuda", "--ks", "4",
                                 "--workloads", "encode", "--size",
                                 str(4 << 20), "--iterations", "2"]) == 0
    finally:
        bench_suite.TECHNIQUES.clear()
        bench_suite.TECHNIQUES.update(saved)
    torch.cuda.synchronize()
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [(r["plugin"], r["technique"], r["m"]) for r in rows] == [
        ("cuda", technique, 2), ("cuda", technique, 3)]
    assert all(r["mbps"] > 0 for r in rows)
    assert kernel.launches > before


def test_device_parity_gate_engages_the_cuda_arm(card):
    """`non_regression --device-parity --device cuda`: the device child's
    store is the CUDA arm and installs, the host child's is not, and the
    digests agree (the gate's exit code)."""
    import json
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.non_regression",
         "--device-parity", "--device", "cuda"],
        cwd=root, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    children = {}
    for line in proc.stdout.splitlines():
        for arm in ("device", "host"):
            prefix = f"device parity {arm} child: "
            if line.startswith(prefix):
                children[arm] = json.loads(line[len(prefix):])
    assert children["device"]["device_arm"] == 1
    assert (children["device"]["device_installs"]
            + children["device"]["h2d_installs"]) > 0
    assert children["host"]["device_arm"] == 0
