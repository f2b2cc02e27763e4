#!/usr/bin/env python3
"""Drive ceph_tpu_torch on one CUDA card and check everything it prints.

    python3 chip_smoke.py          # from the repository root, one card

Phases; any failure exits nonzero before the result line is printed:

1. build    nvcc builds every kernel library from ceph_tpu_torch/ops/csrc
            (one nvcc per source, all started together); seconds and ptxas
            register/spill lines are printed.
2. kernels  each kernel against its plain PyTorch version on the card, byte
            for byte, at the main path's shapes, at 2 MiB of columns, and at
            ragged, misaligned and wide shapes; CUDA-event medians with the
            L2 flushed before each launch (and the host's enqueue kept out
            of the timed window), beside the bound computed from the
            shapes and, for gf2_matmul, an fp16 torch.matmul of the same 0/1
            operands as a yardstick.  Each kernel runs every shape on the
            route its wrapper takes and on the popc route ("path" in each
            line); at the main path's shapes and at 2 MiB the two are timed
            in turns (wrapper's, popc, popc, wrapper's), and a "floor" line
            times a device copy of the same number of bytes, same flush and
            events.  The packed-bit kernels (xor_schedule, apply_packedbit,
            to_packedbit, from_packedbit) likewise, each on its one route,
            with a floor line at each main-path shape; apply_packedbit is
            timed in turns with apply_bytes_w8 on the same operands
            (apply_packedbit, apply_bytes_w8, apply_bytes_w8,
            apply_packedbit), since both compute the same function.
3. main     the port's entry points, three runs, each with every launch
            count set to 0 just before it and read just after:
            a. the packed-bit lane on (the default): the benchmark CLI
               (plugin=cuda reed_sol_van k=8 m=3, 4 MiB objects, encode, then
               decode with 3 random erasures and with chunks 1, 5, 9 erased;
               the CLI verifies recovered content; a "sched" line after each
               gives the schedule LRU's hits, misses and compile seconds in
               it), 4 MiB objects under plugin=cuda against the port's
               CPU plugin=jerasure (reed_sol_van and cauchy_good k=8 m=3),
               and the archived plugin=tpu corpus replayed under
               plugin=cuda.  xor_schedule and apply_packedbit must launch,
               apply_bytes_w8 and gf2_matmul must not;
            b. the same with CEPH_TPU_PACKEDBIT=0: apply_bytes_w8 (every
               launch on the xor route) and gf2_matmul (every launch on the
               mma route) must launch, the packed-bit kernels must not;
            c. a 4 MiB resident round trip: gf2_encode_packedbit_resident,
               to_packedbit of the data against its planes, three data
               chunks' planes zeroed and rebuilt by gf2_xor_packed of a
               decode matrix over the data ‖ parity planes, from_packedbit,
               and the rebuilt chunks and the parity checked against the
               CPU plugin=jerasure.  Every packed-bit kernel must launch.
4. queue    the OSD's path below the daemon, at full width: plugin=cuda
            reed_sol_van k=8 m=3, StripeInfo(k=8, stripe_width=8 * 4096),
            64 seeded 4 MiB objects, one BatchingQueue(device="cuda") at its
            defaults (16 MiB rounds), with every launch count set to 0 just
            before and read just after (the "queue" run):
            a. writes through ecutil.batched_encode_async, in turns with the
               codec called once per object and with a second queue whose
               window is the 50 ms the reference's batching tests set
               (per object, queue, wide, wide, queue, per object); every
               shard list held against the first turn's, 4 objects against
               the CPU plugin=jerasure; objects/s, GB/s, the ec_cuda
               counters, the median host ms of the queue's staging and
               fan-out of a round inside the turn, and K4's launches of
               each turn;
            b. degraded reads (chunks 1, 5, 9 lost) through
               decode_object_async, in the same turns, content checked;
               GB/s and the schedule LRU's hits and misses;
            c. 16 re-encodes as one submit_group (a recovery round);
               then the host's parts of a write, timed alone (medians):
               ecutil's re-interleave of one object into shard rows, the
               queue's staging of a 16 MiB round into pinned memory (host
               copy and the enqueue of its host->device copy; the first
               call apart) and its fan-out of that round's parity;
            d. the other lanes on one object, each against the card's own
               lane function (launches uncounted): submit_packedbit_resident,
               submit_packedbit_planes rebuilding 3 chunks, and with
               CEPH_TPU_PACKEDBIT=0 submit, submit_planar and submit_resident
               at w=8 and w=16;
            e. torch.profiler over 64 writes through the wide-window queue
               (16 rounds of 4 objects): the share of
               host->device copy time under another round's kernel or
               device->host copy, the device's busy share, and the pinned
               host allocations the window made (cudaHostAlloc calls).
            K1-K4 must each launch in the run.  Each line is "queue {...}"
            with the card's name and power limit.
5. split    host prepare / host->device / kernel call (apply_packedbit,
            the lane's one launch) / device->host of one 4 MiB encode (the
            codec API takes host bytes), and the device's busy share over
            back-to-back encodes from torch.profiler.
6. report   the card, one {"kernels": [...]} line (each row's "launches" is
            the sum of its counts in phases 3 and 4, "launches_by_run" the
            four runs), and the result line.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20261016
OBJECT_SIZE = 4 << 20        # the RBD/CephFS default object size
BATCH_COLS = 2 << 20         # 16 stripes of 128 KiB columns
CLI_ITERATIONS = 50
TIMING_REPS = 20
PLAIN_REPS = 5
FLUSH_BYTES = 256 << 20      # > the 50 MB L2
HOST_LEAD_CYCLES = 2_000_000  # about 1 ms at the H100's 1.98 GHz
LOST = (1, 5, 9)             # phase 3's 3-erasure decode
STRIPE_UNIT = 4096           # the OSD's default EC stripe unit
QUEUE_OBJECTS = 64           # writes and degraded reads of the queue phase
RECOVERY_OBJECTS = 16        # re-encodes of its recovery group
# the coalescing window the reference's batching tests set
# (CEPH_TPU_BATCH_DELAY=0.05), beside the 2 ms default
WIDE_WINDOW_S = 0.05
# the chunks a k=8 m=3 packet-layout decode reads when LOST are lost
DECODE_CHOSEN = tuple(c for c in range(11) if c not in LOST)[:8]

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15
# 32-bit integer operations/s outside the tensor cores: 132 SMs of 64 INT32
# units at the 1.98 GHz boost clock (Hopper architecture white paper)
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9

KERNEL_META = {
    "apply_bytes_w8": ("ceph_tpu_torch/ops/csrc/gf2.cu",
                       "ceph_tpu/ops/pallas_gf2.py:57"),
    "gf2_matmul": ("ceph_tpu_torch/ops/csrc/gf2.cu",
                   "ceph_tpu/ops/pallas_gf2.py:93"),
    "xor_schedule": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
                     "ceph_tpu/ops/gf2.py:532"),
    "apply_packedbit": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
                        "ceph_tpu/ops/gf2.py:591"),
    "to_packedbit": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
                     "ceph_tpu/ops/gf2.py:576"),
    "from_packedbit": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
                       "ceph_tpu/ops/gf2.py:584"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(R: int, C: int, B: int, in_bytes: int, out_bytes: int):
    """(bound_ms, bound_by) of an [R, C] bit-matrix applied to B columns: the
    larger of the bytes the function must move (matrix and input read once,
    output written once) over HBM bandwidth and its R*C*B multiply-adds as
    int8 tensor operations."""
    bytes_ms = (R * C + in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    ops_ms = 2.0 * R * C * B / PEAK_INT8_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def xor_bound(n_bytes: int, word_ops: int):
    """(bound_ms, bound_by) of a packed-bit kernel: the bytes it must move
    (inputs read once, outputs written once) over HBM bandwidth, or its
    XORs of 32-bit words over the INT32 rate, whichever is larger."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = word_ops / PEAK_INT32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of one call of `fn` on the card: CUDA events
    around each call, L2 flushed (a 256 MiB memset) before each.  The card
    then spins for about a millisecond, so that the host has enqueued the
    call before its start event runs, even on a busy host."""
    import torch

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------- phase 1 --

def phase_build() -> None:
    from ceph_tpu_torch.ops import build

    t0 = time.perf_counter()
    results = build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f}s total "
          f"({', '.join(f'{n} {s:.2f}s' for n, (s, _) in results.items())})")
    for name, (_, log) in results.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas[{name}] {line.strip()}")


# ---------------------------------------------------------------- phase 2 --

def _tensor(a: np.ndarray, device):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _bitmatrices(device):
    """The main path's bit-matrices: reed_sol_van k=8 m=3 encode, a 3-erasure
    decode, cauchy_good k=8 m=3 (packet layout) and the [64, 64] decode of
    phase 3's erasures {1, 5, 9}, reed_sol_van k=8 m=3 w=16."""
    from ceph_tpu_torch.ec.matrices import (cauchy_good_matrix,
                                            invert_bitmatrix,
                                            matrix_to_bitmatrix,
                                            vandermonde_coding_matrix)

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    chosen, inv = codec.decode_selection({0, 4, 7}, set(range(11)) - {0, 4, 7})
    check(chosen == (1, 2, 3, 5, 6, 8, 9, 10), f"decode selection {chosen}")
    cauchy = matrix_to_bitmatrix(cauchy_good_matrix(8, 3, 8), 8)
    full = np.vstack([np.eye(64, dtype=np.uint8), cauchy])
    rs_decode3 = matrix_to_bitmatrix(inv[[0, 4, 7]], 8)
    return {
        "rs_encode": matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 8), 8),
        "rs_decode3": rs_decode3,
        "rs_decode3_resident": resident_decode_bitmatrix(rs_decode3, chosen),
        "cauchy_good": cauchy,
        "cauchy_decode3": invert_bitmatrix(np.vstack(
            [full[c * 8:(c + 1) * 8] for c in DECODE_CHOSEN])),
        "rs_w16": matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 16), 16),
    }


def resident_decode_bitmatrix(bm: np.ndarray, chosen, n_chunks: int = 11):
    """A decode bit-matrix over the chosen chunks' planes, spread over the
    planes of all n_chunks chunks (data ‖ parity), zero on the others."""
    out = np.zeros((bm.shape[0], n_chunks * 8), dtype=np.uint8)
    for i, c in enumerate(chosen):
        out[:, c * 8:(c + 1) * 8] = bm[:, i * 8:(i + 1) * 8]
    return out


def phase_kernels(device):
    """Each kernel against its plain version; returns the rows for the
    report (main-path shape) and prints one line per compared shape."""
    import torch

    from ceph_tpu_torch.ops import cuda_gf2

    rng = np.random.default_rng(SEED)
    bms = _bitmatrices(device)
    main_cols = OBJECT_SIZE // 8  # k=8: a 4 MiB object's chunk bytes
    rows = {}

    # Both kernels have two routes.  Every shape runs on the route the
    # wrapper takes for it and on the popc route (the first port's kernel);
    # the timed shapes time the two in turns (wrapper's, popc, popc,
    # wrapper's) and a device copy of the kernel's bytes as a floor.
    routed = {"apply_bytes_w8": (cuda_gf2.apply_bytes_w8,
                                 cuda_gf2.apply_bytes_w8_popc,
                                 cuda_gf2.apply_bytes_w8_plain),
              "gf2_matmul": (cuda_gf2.gf2_matmul, cuda_gf2.gf2_matmul_popc,
                             cuda_gf2.gf2_matmul_plain)}

    def both_routes(name, bm, x, label, in_bytes, out_bytes, report=False,
                    turns=False, library=None):
        wrapper, popc, plain = routed[name]
        B = x.shape[1]
        R, C = bm.shape
        routes = {}
        for fn in (wrapper, popc):
            before = dict(wrapper.routes)
            got = fn(bm, x)
            route, = (r for r, n in wrapper.routes.items() if n != before[r])
            routes[route] = (fn, got)
        want = plain(bm, x)
        sync(device)
        b_ms, b_by = bound(R, C, B, in_bytes, out_bytes)
        order = list(routes)
        if turns:
            order = order + order[::-1]
        times = {r: [] for r in routes}
        for r in order:
            times[r].append(time_ms(lambda: routes[r][0](bm, x), TIMING_REPS))
        plain_ms = time_ms(lambda: plain(bm, x), PLAIN_REPS)
        library_ms = time_ms(library, TIMING_REPS) if library else None
        for r, (_, got) in routes.items():
            check(got.shape == want.shape and got.dtype == want.dtype,
                  f"{name} {r} {label}: {tuple(got.shape)}/{got.dtype}")
            err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
            check(err == 0, f"{name} {r} {label}: max_abs_err {err}")
            line = {"kernel": name, "path": r, "shape": label,
                    "max_abs_err": err, "ms": statistics.mean(times[r]),
                    "ms_turns": times[r], "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": library_ms}
            print("kernel " + json.dumps(line))
            if report:
                rows[name if r == order[0] else name + ".popc"] = dict(line)
        if turns:
            n = (in_bytes + out_bytes) // 2  # read n and write n: the kernel's bytes
            src = torch.empty(n, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            print("floor " + json.dumps({
                "kernel": name, "shape": label, "copy_bytes": n,
                "ms": time_ms(lambda: dst.copy_(src), TIMING_REPS)}))
            del src, dst
        sync(device)

    # K1: w=8 byte layout
    def k1(bm, data, label, **kw):
        k, B = data.shape
        both_routes("apply_bytes_w8", bm, data, label, k * B,
                    bm.shape[0] // 8 * B, **kw)

    bm_enc = _tensor(bms["rs_encode"].astype(np.int8), device)
    for mat, B, report in (("rs_encode", main_cols, True),
                           ("rs_encode", BATCH_COLS, False),
                           ("rs_decode3", BATCH_COLS, False)):
        data = _tensor(rng.integers(0, 256, (8, B), dtype=np.uint8), device)
        k1(_tensor(bms[mat].astype(np.int8), device), data,
           f"{mat} [24,64]x[8,{B}]", report=report, turns=True)
    for B in (1, 3, 31, 1000, 32768 + 17):
        data = _tensor(rng.integers(0, 256, (8, B), dtype=np.uint8), device)
        k1(bm_enc, data, f"rs_encode [24,64]x[8,{B}]")
    # misaligned base (byte accesses), other parity counts, wider k
    flat = _tensor(rng.integers(0, 256, 8 * 4096 + 1, dtype=np.uint8), device)
    k1(bm_enc, flat[1:].view(8, 4096), "rs_encode [24,64]x[8,4096] base+1")
    for k, m, B in ((8, 1, 4096), (8, 2, 31), (8, 4, main_cols),
                    (16, 4, 4112), (12, 4, 10001), (40, 2, 3001)):
        bm = _tensor(rng.integers(0, 2, (m * 8, k * 8), dtype=np.int8), device)
        data = _tensor(rng.integers(0, 256, (k, B), dtype=np.uint8), device)
        k1(bm, data, f"random [{m * 8},{k * 8}]x[{k},{B}]")

    # K2: int8 bit-planes.  The main path's three launches (cauchy_good
    # encode, its 3-erasure decode, the parity re-encode) and 2 MiB of
    # columns, timed, beside an fp16 torch.matmul of the same 0/1 operands.
    def k2(bm, bits, label, **kw):
        (R, C), B = bm.shape, bits.shape[1]
        both_routes("gf2_matmul", bm, bits, label, C * B, R * B, **kw)

    for mat, B, report in (("cauchy_good", main_cols, True),
                           ("cauchy_decode3", main_cols, False),
                           ("cauchy_good", BATCH_COLS, False),
                           ("rs_w16", BATCH_COLS, False)):
        bm_np = bms[mat].astype(np.int8)
        R, C = bm_np.shape
        bm = _tensor(bm_np, device)
        bits = _tensor(rng.integers(0, 2, (C, B), dtype=np.int8), device)
        bm_h, bits_h = bm.half(), bits.half()
        k2(bm, bits, f"{mat} [{R},{C}]x[{C},{B}]", report=report, turns=True,
           library=lambda: torch.matmul(bm_h, bits_h))
        del bits, bits_h
    # int8 negatives, zero-padded R and C, ragged B, misaligned bases, and
    # shapes past the mma route's limits
    for R, C, B, offset in ((24, 64, 1001, 0), (64, 64, 32768 + 16, 1),
                            (48, 128, 4112, 16), (5, 40, 1040, 0),
                            (17, 100, 304, 0), (5, 200, 300, 0),
                            (7, 600, 77, 0)):
        M = _tensor(rng.integers(-128, 128, (R, C), dtype=np.int8), device)
        flat = _tensor(rng.integers(-128, 128, C * B + offset, dtype=np.int8),
                       device)
        k2(M, flat[offset:].view(C, B),
           f"int8 [{R},{C}]x[{C},{B}]" + (f" base+{offset}" if offset else ""))
    phase_packedbit(device, bms, rng, rows)
    return rows


def phase_packedbit(device, bms, rng, rows) -> None:
    """K3-K6 against their plain versions, byte for byte; the main-path
    shapes and 2 MiB of columns timed, with floors, K4 in turns with K1."""
    import torch

    from ceph_tpu_torch.ops import cuda_gf2
    from ceph_tpu_torch.ops import cuda_packedbit as pb
    from ceph_tpu_torch.ops.gf2 import xor_schedule_program

    main_cols = OBJECT_SIZE // 8

    def program(bm, cse=True):
        ops, outs, n_xors = xor_schedule_program(bm, cse=cse)
        return pb.Program(ops, outs, bm.shape[1]), n_xors

    def compare(name, fn, plain, label, n_bytes, word_ops, timed=False,
                report=False, floor=False):
        wrapper = getattr(pb, name)
        before = dict(getattr(wrapper, "routes", {}))
        got = fn()
        after = getattr(wrapper, "routes", {})
        path = next((r for r in after if after[r] != before[r]), "cuda")
        # K3 and K4: the launch's groups, longest sub-program, warps an SM
        block = dict(getattr(wrapper, "last", None) or {})
        block.pop("route", None)
        want = plain()
        sync(device)
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        err = 0
        for g, w in pairs:
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"{name} {label}: {tuple(g.shape)}/{g.dtype} against "
                  f"{tuple(w.shape)}/{w.dtype}")
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                               .abs().max()))
        check(err == 0, f"{name} {label}: max_abs_err {err}")
        line = {"kernel": name, "path": path, "shape": label,
                "max_abs_err": err, **block}
        if timed:
            b_ms, b_by = xor_bound(n_bytes, word_ops)
            line.update(ms=time_ms(fn, TIMING_REPS),
                        plain_ms=time_ms(plain, PLAIN_REPS), bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
        print("kernel " + json.dumps(line))
        if report:
            rows[name] = line
        if floor:
            n = n_bytes // 2  # read n and write n: the kernel's bytes
            src = torch.empty(n, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            print("floor " + json.dumps({
                "kernel": name, "shape": label, "copy_bytes": n,
                "ms": time_ms(lambda: dst.copy_(src), TIMING_REPS)}))
            del src, dst
        return line

    progs = {name: program(bms[name]) for name in
             ("rs_encode", "rs_decode3", "rs_decode3_resident", "cauchy_good",
              "cauchy_decode3")}
    zero_row = bms["rs_encode"].copy()
    zero_row[5] = 0
    progs["zero_row"] = program(zero_row)
    progs["nocse"] = program(bms["rs_encode"], cse=False)
    from ceph_tpu_torch.ec.matrices import (matrix_to_bitmatrix,
                                            vandermonde_coding_matrix)
    progs["k20m6"] = program(matrix_to_bitmatrix(
        vandermonde_coding_matrix(20, 6, 8), 8))

    def rand(dtype, shape, offset=0):
        info = np.iinfo(dtype)
        n = int(np.prod(shape))
        flat = _tensor(rng.integers(info.min, info.max, n + offset,
                                    dtype=dtype), device)
        return flat[offset:].view(*shape)

    # K3: packet rows of the cauchy_good encode and 3-erasure decode and the
    # resident decode's plane words (main path), 2 MiB of columns as plane
    # words, then ragged, misaligned, zero-row, no-CSE and k=20 m=6 programs
    def k3(pname, rows_in, label, **kw):
        prog, n_xors = progs[pname]
        rb = rows_in.shape[1] * rows_in.element_size()
        compare("xor_schedule", lambda: pb.xor_schedule(prog, rows_in),
                lambda: pb.xor_schedule_plain(prog, rows_in),
                f"{pname} [{prog.R},{prog.C}]x{list(rows_in.shape)} "
                f"{str(rows_in.dtype)[6:]}{label}",
                (prog.C + prog.R) * rb, n_xors * -(-rb // 4), **kw)

    # a 4 MiB cauchy_good k=8 m=3 object: 64 packet rows of 64 KiB
    k3("cauchy_good", rand(np.uint8, (64, main_cols // 8)), "", timed=True,
       report=True, floor=True)
    k3("cauchy_decode3", rand(np.uint8, (64, main_cols // 8)), "", timed=True,
       floor=True)
    k3("rs_decode3_resident", rand(np.int32, (88, main_cols // 32)), "",
       timed=True, floor=True)
    k3("rs_encode", rand(np.int32, (64, BATCH_COLS // 32)), "", timed=True)
    for N in (1, 31, 1000):
        k3("rs_encode", rand(np.uint8, (64, N)), "")
    k3("rs_encode", rand(np.uint8, (64, 4096), offset=1), " base+1")
    k3("rs_encode", rand(np.uint8, (64, 4096), offset=4), " base+4")
    k3("rs_encode", rand(np.int32, (66, 1001), offset=1), " base+4")
    for pname in ("zero_row", "nocse"):
        k3(pname, rand(np.int32, (64, 4096)), "")
    k3("k20m6", rand(np.uint8, (160, 65536)), "")
    k3("k20m6", rand(np.int32, (160, 1000)), "")

    # K4: both forms, the encode in turns with K1 on the same operands
    def k4(pname, data, label, resident=False, **kw):
        prog, n_xors = progs[pname]
        k, B = data.shape
        W = -(-B // 32)
        n_bytes = k * B + prog.R // 8 * B
        if resident:
            n_bytes += (prog.C + prog.R) * W * 4
        return compare(
            "apply_packedbit",
            lambda: pb.apply_packedbit(prog, data, resident),
            lambda: pb.apply_packedbit_plain(prog, data, resident),
            f"{pname}{' resident' if resident else ''} [{prog.R},{prog.C}]x"
            f"[{k},{B}]{label}", n_bytes, n_xors * W, **kw)

    data = rand(np.uint8, (8, main_cols))
    main = k4("rs_encode", data, "", timed=True, report=True, floor=True)
    bm_enc = _tensor(bms["rs_encode"].astype(np.int8), device)
    prog = progs["rs_encode"][0]
    turns = {"apply_packedbit": [], "apply_bytes_w8": []}
    for name in ("apply_packedbit", "apply_bytes_w8", "apply_bytes_w8",
                 "apply_packedbit"):
        fn = ((lambda: pb.apply_packedbit(prog, data))
              if name == "apply_packedbit"
              else (lambda: cuda_gf2.apply_bytes_w8(bm_enc, data)))
        turns[name].append(time_ms(fn, TIMING_REPS))
    print("turns " + json.dumps({"shape": main["shape"], **turns}))
    rows["apply_packedbit"]["ms_turns"] = turns["apply_packedbit"]
    rows["apply_packedbit"]["apply_bytes_w8_ms_turns"] = turns["apply_bytes_w8"]
    k4("rs_encode", data, "", resident=True, timed=True)
    k4("rs_decode3", rand(np.uint8, (8, main_cols)), "", timed=True)
    k4("rs_encode", rand(np.uint8, (8, BATCH_COLS)), "", timed=True)
    for B in (1, 31, 1000, 32768 + 17):
        k4("rs_encode", rand(np.uint8, (8, B)), "", resident=True)
    k4("rs_encode", rand(np.uint8, (8, 4096), offset=1), " base+1")
    for pname in ("zero_row", "nocse"):
        k4(pname, rand(np.uint8, (8, 4096)), "", resident=True)
    k4("k20m6", rand(np.uint8, (20, 65536 + 8)), "", resident=True)

    # K5 and K6: the two transposes
    def k5(data, label, **kw):
        n, B = data.shape
        compare("to_packedbit", lambda: pb.to_packedbit(data),
                lambda: pb.to_packedbit_plain(data), f"[{n},{B}]{label}",
                n * B + n * 8 * -(-B // 32) * 4, 0, **kw)

    def k6(planes, label, **kw):
        R8, W = planes.shape
        compare("from_packedbit", lambda: pb.from_packedbit(planes, R8 // 8),
                lambda: pb.from_packedbit_plain(planes, R8 // 8),
                f"[{R8},{W}]{label}", R8 * W * 4 + R8 // 8 * W * 32, 0, **kw)

    k5(rand(np.uint8, (8, main_cols)), "", timed=True, report=True, floor=True)
    k5(rand(np.uint8, (8, BATCH_COLS)), "", timed=True)
    for B in (1, 31, 1000):
        k5(rand(np.uint8, (8, B)), "")
    k5(rand(np.uint8, (8, 4096), offset=1), " base+1")
    k6(rand(np.int32, (24, main_cols // 32)), "", timed=True, report=True,
       floor=True)
    k6(rand(np.int32, (24, BATCH_COLS // 32)), "", timed=True)
    for W in (1, 31):
        k6(rand(np.int32, (24, W)), "")
    k6(rand(np.int32, (24, 1000), offset=1), " base+4")


# ---------------------------------------------------------------- phase 3 --

def _run_cli(argv, label):
    """One benchmark CLI run; prints its rate and what the schedule LRU did
    in it (gf2_sched deltas: hits, misses, seconds spent compiling)."""
    from ceph_tpu_torch.ops.gf2 import SCHED_PERF
    from ceph_tpu_torch.tools import benchmark

    before = SCHED_PERF.dump()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(argv)
    after = SCHED_PERF.dump()
    text = out.getvalue().strip()
    check(rc == 0, f"benchmark {' '.join(argv)} exited {rc}")
    seconds, kb = text.split("\t")
    gbps = int(kb) * 1024 / float(seconds) / 1e9
    print(f"cli {label}: {text!r} -> {gbps:.3f} GB/s of object data")
    compile_s = after["compile_s"]["sum"] - before["compile_s"]["sum"]
    print("sched " + json.dumps({
        "cli": label, "seconds": float(seconds),
        **{k: after[k] - before[k] for k in ("hit", "miss", "compile")},
        "compile_s": compile_s, "compile_share": compile_s / float(seconds)}))


def _codec(plugin: str, device, **profile):
    """A codec through a registry, as the benchmark CLI resolves it: with a
    CudaPlugin for `device` registered as plugin=cuda."""
    from ceph_tpu_torch.ec.plugins.cuda import CudaPlugin
    from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry

    registry = ErasureCodePluginRegistry()
    registry.add("cuda", CudaPlugin(device=device))
    profile = {"plugin": plugin, **{k: str(v) for k, v in profile.items()}}
    return registry.factory(plugin, "", profile)


def _replay_corpus(device) -> None:
    directory = os.path.join(ROOT, "corpus", "plugin=tpu stripe-width=4096 k=8 m=3")
    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    with open(os.path.join(directory, "content"), "rb") as f:
        content = f.read()
    archived = {}
    for c in range(11):
        with open(os.path.join(directory, str(c)), "rb") as f:
            archived[c] = np.frombuffer(f.read(), dtype=np.uint8)
    encoded = codec.encode(set(range(11)), content)
    for c in range(11):
        check(np.array_equal(encoded[c], archived[c]),
              f"corpus chunk {c} re-encodes differently")
    for erasures in ({0}, {0, 10}):
        avail = {c: b for c, b in archived.items() if c not in erasures}
        out = codec.decode(erasures, avail, len(archived[0]))
        for c in erasures:
            check(np.array_equal(out[c], archived[c]),
                  f"corpus chunk {c} decoded wrong (erasures {sorted(erasures)})")
    print("corpus: plugin=tpu stripe-width=4096 k=8 m=3 replays under "
          "plugin=cuda (encode, 1- and 2-erasure decode)")


def _wrappers():
    """Every kernel's wrapper, by the name the report gives it."""
    from ceph_tpu_torch.ops import cuda_gf2, cuda_packedbit

    return {"apply_bytes_w8": cuda_gf2.apply_bytes_w8,
            "gf2_matmul": cuda_gf2.gf2_matmul,
            "xor_schedule": cuda_packedbit.xor_schedule,
            "apply_packedbit": cuda_packedbit.apply_packedbit,
            "to_packedbit": cuda_packedbit.to_packedbit,
            "from_packedbit": cuda_packedbit.from_packedbit}


def _zero_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes = dict.fromkeys(fn.routes, 0)


def _read_counts(device, run: str):
    sync(device)
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    routes = {name: dict(fn.routes) for name, fn in _wrappers().items()
              if hasattr(fn, "routes")}
    print(f"main path {run} launches: {json.dumps(counts)}")
    print(f"main path {run} routes: {json.dumps(routes)}")
    return counts, routes


def _codec_path(device) -> None:
    """The CLI, the identity checks against CPU jerasure and the corpus."""
    base = ["--plugin", "cuda", "--device", str(device), "-P",
            "technique=reed_sol_van", "-P", "k=8", "-P", "m=3",
            "--size", str(OBJECT_SIZE), "--iterations", str(CLI_ITERATIONS)]
    _run_cli(base + ["--workload", "encode"], "encode")
    _run_cli(base + ["--workload", "decode", "--erasures", "3"],
             "decode, 3 random erasures")
    _run_cli(base + ["--workload", "decode"]
             + [arg for c in LOST for arg in ("--erased", str(c))],
             f"decode, erased {list(LOST)}")

    obj = np.random.default_rng(SEED).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    for profile in (dict(technique="reed_sol_van", k=8, m=3),
                    dict(technique="cauchy_good", k=8, m=3, packetsize=2048)):
        cuda = _codec("cuda", device, **profile)
        cpu = _codec("jerasure", "cpu", **profile)
        ec, ej = cuda.encode(set(range(11)), obj), cpu.encode(set(range(11)), obj)
        for c in range(11):
            check(np.array_equal(ec[c], ej[c]),
                  f"{profile['technique']} chunk {c}: plugin=cuda differs "
                  "from the CPU plugin=jerasure")
        lost = set(LOST)
        out = cuda.decode(lost, {c: ec[c] for c in ec if c not in lost},
                          len(ec[0]))
        for c in lost:
            check(np.array_equal(out[c], ej[c]),
                  f"{profile['technique']} chunk {c} decoded wrong")
        print(f"identity: plugin=cuda {profile['technique']} k=8 m=3, "
              f"{OBJECT_SIZE} byte object = CPU plugin=jerasure, 11 chunks of "
              f"{len(ec[0])} bytes; 3-erasure decode exact")
    _replay_corpus(device)


def _resident_round_trip(device) -> None:
    """A 4 MiB object through the resident form of the packed-bit lane:
    encode to parity and data ‖ parity planes, lose three data chunks'
    planes, rebuild them from the other planes, and leave planes for bytes."""
    import torch

    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
    from ceph_tpu_torch.ops import gf2 as lane

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    cpu = _codec("jerasure", "cpu", technique="reed_sol_van", k=8, m=3)
    obj = np.random.default_rng(SEED + 2).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    chunks = codec.encode_prepare(obj, codec.get_chunk_size(len(obj)))
    B = chunks.shape[1]
    data = torch.from_numpy(chunks).to(device)
    parity, planes = lane.gf2_encode_packedbit_resident(
        matrix_to_bitmatrix(codec.matrix, 8), data)
    want = cpu.encode(set(range(11)), obj)
    got = parity.cpu().numpy()
    for c in range(3):
        check(np.array_equal(got[c], want[8 + c]),
              f"resident parity chunk {8 + c} differs from CPU jerasure")
    check(torch.equal(lane.to_packedbit(data), planes[:64]),
          "to_packedbit of the data differs from its resident planes")
    lost = (0, 4, 7)
    chosen, inv = codec.decode_selection(set(lost), set(range(11)) - set(lost))
    decode = resident_decode_bitmatrix(
        matrix_to_bitmatrix(inv[list(lost)], 8), chosen)
    damaged = planes.clone()
    for c in lost:
        damaged[c * 8:(c + 1) * 8] = 0
    rebuilt = lane.from_packedbit(lane.gf2_xor_packed(decode, damaged),
                                  len(lost))[:, :B].cpu().numpy()
    for i, c in enumerate(lost):
        check(np.array_equal(rebuilt[i], chunks[c]),
              f"resident round trip rebuilt chunk {c} wrong")
    print(f"resident: {OBJECT_SIZE} byte object encoded to {tuple(planes.shape)} "
          f"plane words, parity = CPU jerasure, chunks {list(lost)} rebuilt "
          f"from chunks {list(chosen)}'s planes")


def phase_main(device):
    """The port's main path, three runs; returns each kernel's launch counts
    by run and the K1/K2 routes of the run with the lane off."""
    _zero_counts()
    _codec_path(device)
    on, _ = _read_counts(device, "(packed-bit lane on)")
    for name in ("xor_schedule", "apply_packedbit"):
        check(on[name] > 0, f"{name} never launched with the lane on")
    for name in ("apply_bytes_w8", "gf2_matmul"):
        check(on[name] == 0, f"{name} launched with the packed-bit lane on")

    saved = os.environ.get("CEPH_TPU_PACKEDBIT")
    os.environ["CEPH_TPU_PACKEDBIT"] = "0"
    try:
        _zero_counts()
        _codec_path(device)
        off, routes = _read_counts(device, "(CEPH_TPU_PACKEDBIT=0)")
    finally:
        if saved is None:
            os.environ.pop("CEPH_TPU_PACKEDBIT")
        else:
            os.environ["CEPH_TPU_PACKEDBIT"] = saved
    for name, route in (("apply_bytes_w8", "xor"), ("gf2_matmul", "mma")):
        check(off[name] > 0, f"{name} never launched with the lane off")
        check(routes[name][route] == off[name],
              f"{name} left the {route} route on the main path: {routes[name]}")
    for name in ("xor_schedule", "apply_packedbit"):
        check(off[name] == 0, f"{name} launched with CEPH_TPU_PACKEDBIT=0")

    _zero_counts()
    _resident_round_trip(device)
    res, _ = _read_counts(device, "(resident round trip)")
    for name in ("xor_schedule", "apply_packedbit", "to_packedbit",
                 "from_packedbit"):
        check(res[name] > 0, f"{name} never launched in the resident round trip")
    counts = {name: {"lane_on": on[name], "lane_off": off[name],
                     "resident": res[name]} for name in on}
    return counts, routes


# ------------------------------------------------------------ phase queue --

@contextlib.contextmanager
def _uncounted(device):
    """Launches inside are comparisons with the lane functions, not the
    main path: every count is put back as it was."""
    sync(device)
    saved = {name: (fn.launches, dict(getattr(fn, "routes", {})))
             for name, fn in _wrappers().items()}
    try:
        yield
    finally:
        sync(device)
        for name, fn in _wrappers().items():
            fn.launches = saved[name][0]
            if hasattr(fn, "routes"):
                fn.routes = saved[name][1]


def _interval_union(spans):
    """Sorted, merged (start, end) intervals."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a, b, merged) -> float:
    """Length of (a, b) inside the merged intervals."""
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
               if x < b and y > a)


def phase_queue(device, card):
    """The OSD's path below the daemon on the card: writes, degraded reads
    and a recovery group through ecutil and one BatchingQueue at its
    defaults, each held against the codec called once per object; then the
    other lanes, and the overlap of rounds from a profiler trace.  Returns
    each kernel's launch count in this run."""
    import asyncio

    import torch

    from ceph_tpu_torch.ops import cuda_packedbit
    from ceph_tpu_torch.ops.gf2 import SCHED_PERF
    from ceph_tpu_torch.parallel.service import BatchingQueue
    from ceph_tpu_torch.rados import ecutil

    def emit(step, **numbers):
        print("queue " + json.dumps({"step": step, **numbers, "card": card}))

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    cpu = _codec("jerasure", "cpu", technique="reed_sol_van", k=8, m=3)
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * STRIPE_UNIT)
    rng = np.random.default_rng(SEED + 3)
    objs = [rng.integers(0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
            for _ in range(QUEUE_OBJECTS)]
    total = QUEUE_OBJECTS * OBJECT_SIZE

    def same(got, want, what):
        for i, (g, w) in enumerate(zip(got, want)):
            check(len(g) == len(w) == 11 and all(
                np.array_equal(a, b) for a, b in zip(g, w)),
                f"queue {what}: object {i}'s shards differ")

    async def writes(q):
        return await asyncio.gather(*(ecutil.batched_encode_async(
            codec, sinfo, o, queue=q) for o in objs))

    q = BatchingQueue(device=device)
    wide = BatchingQueue(device=device, max_delay=WIDE_WINDOW_S)
    queues = {"queue": q, "queue_wide": wide}
    arms = ("per_object", "queue", "queue_wide", "queue_wide", "queue",
            "per_object")
    _zero_counts()
    try:
        # 1. writes: the codec once per object, and the two queues, in turns
        want, turns = None, {arm: [] for arm in arms}
        for arm in arms:
            qq = queues.get(arm)
            timed = {"_stage": [], "_complete_packedbit": []}
            if qq is not None:
                qq.perf.reset()
                for name, into in timed.items():
                    _time_calls(qq, name, into)
            k4 = cuda_packedbit.apply_packedbit.launches
            t0 = time.perf_counter()
            if qq is not None:
                got = asyncio.run(writes(qq))
            else:
                got = [ecutil.batched_encode(codec, sinfo, o) for o in objs]
            seconds = time.perf_counter() - t0
            turns[arm].append(seconds)
            if want is None:
                want = got
            else:
                same(got, want, f"writes ({arm})")
            emit("writes", arm=arm, objects=QUEUE_OBJECTS, seconds=seconds,
                 objects_per_s=QUEUE_OBJECTS / seconds,
                 gb_per_s=total / seconds / 1e9,
                 k4_launches=cuda_packedbit.apply_packedbit.launches - k4)
            if qq is not None:
                for name in timed:
                    del qq.__dict__[name]
                d = qq.perf.dump()
                emit("counters", arm=arm, max_delay_s=qq.max_delay,
                     **{key: d[key] for key in (
                         "dispatch", "flush_bytes", "flush_delay",
                         "flush_forced", "overlapped_rounds", "breaker_trip",
                         "breaker_fallback")},
                     group_size=d["group_size"],
                     queue_wait_avg_s=qq.perf.avg("queue_wait"),
                     dispatch_dev_avg_s=qq.perf.avg("dispatch_dev"),
                     stage_in_turn_ms=statistics.median(timed["_stage"]),
                     fan_out_in_turn_ms=statistics.median(
                         timed["_complete_packedbit"]))
        for i in range(4):
            same([want[i]], [ecutil.batched_encode(cpu, sinfo, objs[i])],
                 "writes against CPU plugin=jerasure")
        emit("writes checked", objects=QUEUE_OBJECTS,
             against_cpu_jerasure=4,
             **{f"{arm}_speedup": sum(turns["per_object"]) / sum(turns[arm])
                for arm in queues})

        # 2. degraded reads: chunks 1, 5, 9 lost
        blobs = [{c: s for c, s in enumerate(shards) if c not in LOST}
                 for shards in want]

        async def reads(qq):
            return await asyncio.gather(*(ecutil.decode_object_async(
                codec, sinfo, b, OBJECT_SIZE, queue=qq) for b in blobs))

        for arm in arms:
            qq = queues.get(arm)
            before = SCHED_PERF.dump()
            d0 = qq.dispatches if qq is not None else 0
            t0 = time.perf_counter()
            if qq is not None:
                got = asyncio.run(reads(qq))
            else:
                got = [ecutil.decode_object(codec, sinfo, b, OBJECT_SIZE)
                       for b in blobs]
            seconds = time.perf_counter() - t0
            check(got == objs, f"queue degraded reads ({arm}): content")
            after = SCHED_PERF.dump()
            emit("degraded reads", arm=arm, lost=list(LOST),
                 seconds=seconds, gb_per_s=total / seconds / 1e9,
                 dispatches=(qq.dispatches - d0) if qq is not None else 0,
                 sched_hit=after["hit"] - before["hit"],
                 sched_miss=after["miss"] - before["miss"])

        # 3. recovery: one group of re-encodes, one submit_group
        d0, g0 = q.dispatches, q.perf.get("submit_group")
        t0 = time.perf_counter()
        got = asyncio.run(ecutil.batched_encode_group_async(
            codec, sinfo, objs[:RECOVERY_OBJECTS], queue=q))
        seconds = time.perf_counter() - t0
        same(got, want[:RECOVERY_OBJECTS], "recovery group")
        check(q.perf.get("submit_group") == g0 + 1, "recovery: one group")
        emit("recovery", objects=RECOVERY_OBJECTS, seconds=seconds,
             dispatches=q.dispatches - d0, submit_group=1)
        emit("host parts", **_host_parts(device, codec, sinfo, objs,
                                         q.max_pending_bytes // OBJECT_SIZE))

        phase_queue_lanes(device, q, codec, sinfo, objs[0], want[0], emit)

        # 5. the overlap of rounds, from one profiled window of 64 writes
        # through the wide-window queue (16 rounds of 4 objects)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            d0 = wide.dispatches
            t0 = time.perf_counter()
            got = asyncio.run(writes(wide))
            sync(device)
            wall_us = (time.perf_counter() - t0) * 1e6
            rounds = wide.dispatches - d0
        same(got, want, "profiled writes")
        spans = {"h2d": [], "d2h": [], "kernel": [], "other": []}
        api = collections.Counter()  # CUDA runtime calls the host made
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                if e.name.startswith("cuda"):
                    api[e.name] += 1
                continue
            name = e.name.lower()
            kind = ("h2d" if "htod" in name else "d2h" if "dtoh" in name
                    else "other" if "memset" in name or "memcpy" in name
                    else "kernel")
            spans[kind].append((e.time_range.start, e.time_range.end))
        check(spans["h2d"] and spans["kernel"],
              f"profiler saw no copies or kernels: {dict((k, len(v)) for k, v in spans.items())}")
        others = _interval_union(spans["kernel"] + spans["d2h"])
        h2d_us = sum(b - a for a, b in spans["h2d"])
        busy_us = sum(b - a for a, b in _interval_union(
            [iv for v in spans.values() for iv in v]))
        emit("overlap", arm="queue_wide", rounds=rounds,
             wall_ms=wall_us / 1e3,
             h2d_ms=h2d_us / 1e3,
             h2d_overlapped_share=sum(_overlap(a, b, others)
                                      for a, b in spans["h2d"]) / h2d_us,
             device_busy_ms=busy_us / 1e3,
             device_busy_share=busy_us / wall_us,
             events={k: len(v) for k, v in spans.items()},
             host_allocs=sum(n for name, n in api.items()
                             if "HostAlloc" in name or "MallocHost" in name),
             runtime_calls=sum(api.values()))
    finally:
        q.close()
        wide.close()
    counts, _ = _read_counts(device, "(queue)")
    for name in ("apply_bytes_w8", "gf2_matmul", "xor_schedule",
                 "apply_packedbit"):
        check(counts[name] > 0, f"{name} never launched in the queue run")
    return counts


def _time_calls(obj, name: str, into: list) -> None:
    """Shadow obj.<name> with a wrapper that appends the host milliseconds
    of each call to `into`; `del obj.__dict__[name]` takes it away."""
    real = getattr(obj, name)

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            into.append((time.perf_counter() - t0) * 1e3)

    setattr(obj, name, timed)


def _host_parts(device, codec, sinfo, objs, per_round: int) -> dict:
    """Host milliseconds, medians of TIMING_REPS, of a queue write's parts
    outside the device, each timed alone on the code the path runs:
    ecutil's re-interleave of one object into [k, n] shard rows
    (_encode_plan_parts), the queue's staging of a round of `per_round`
    objects (the copy into pinned memory and the enqueue of the
    host->device copy; the first call reported apart) and its fan-out
    of that round's parity to the requests.  No kernel is launched."""
    from concurrent.futures import Future

    import torch

    from ceph_tpu_torch.parallel import service
    from ceph_tpu_torch.rados import ecutil

    n_stripes = OBJECT_SIZE // sinfo.stripe_width
    arrs = [np.frombuffer(o, dtype=np.uint8).reshape(
        n_stripes, sinfo.k, sinfo.chunk_size) for o in objs[:per_round]]
    plans = [ecutil._encode_plan_parts(codec, sinfo, a, n_stripes)
             for a in arrs]
    kind, mat, _, w, m, _ = plans[0]
    probe = service.BatchingQueue(device=device, max_delay=60.0)
    parts = {"re_interleave_ms": [], "stage_ms": [], "fan_out_ms": []}
    try:
        for i in range(TIMING_REPS + 1):
            t0 = time.perf_counter()
            ecutil._encode_plan_parts(codec, sinfo, arrs[i % len(arrs)],
                                      n_stripes)
            t1 = time.perf_counter()
            g = service._Group(mbits=mat, w=w, out_rows=m, kind=kind,
                               requests=[service._Request(p[2], Future(), t1)
                                         for p in plans])
            with probe._on_device():
                t2 = time.perf_counter()
                widths, batch, nbytes = probe._stage(g)
                t3 = time.perf_counter()
                host = probe._to_host(torch.zeros((m, batch.shape[1]),
                                                  dtype=torch.uint8,
                                                  device=batch.device))
            sync(device)
            t4 = time.perf_counter()
            probe._complete_packedbit(g, (widths, host, nbytes))
            t5 = time.perf_counter()
            if i == 0:
                first_stage_ms = (t3 - t2) * 1e3
                continue
            for key, (a, b) in zip(parts, ((t0, t1), (t2, t3), (t4, t5))):
                parts[key].append((b - a) * 1e3)
    finally:
        probe.close()
    return {"objects_per_round": per_round,
            "round_bytes": per_round * OBJECT_SIZE,
            **{k: statistics.median(v) for k, v in parts.items()},
            "stage_first_ms": first_stage_ms}


def phase_queue_lanes(device, q, codec, sinfo, obj, shards, emit) -> None:
    """Step 4 of the queue phase: the lanes the writes do not take, each
    held against the card's own lane function (uncounted) on one 4 MiB
    object, and the parity against the CPU plugin=jerasure shards."""
    import torch

    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
    from ceph_tpu_torch.ops import gf2 as lane
    from ceph_tpu_torch.rados import ecutil

    flat = np.stack(shards[:8])  # the object's [8, 524288] data rows
    parity = np.stack(shards[8:])
    data = torch.from_numpy(flat).to(device)
    bm = matrix_to_bitmatrix(codec.matrix, 8)

    # packedbit_resident: parity bytes and data ‖ parity plane words
    got_parity, planes = q.submit_packedbit_resident(
        bm.astype(np.uint8), flat, 8, 3).result(timeout=120)
    check(np.array_equal(got_parity, parity),
          "submit_packedbit_resident parity differs from CPU jerasure")
    with _uncounted(device):
        want_planes = lane.gf2_encode_packedbit_resident(bm, data)[1]
    check(torch.equal(planes, want_planes),
          "submit_packedbit_resident planes differ from the lane function")

    # packedbit_planes: chunks 0, 4, 7 rebuilt from the other planes
    lost = (0, 4, 7)
    chosen, inv = codec.decode_selection(set(lost), set(range(11)) - set(lost))
    decode = resident_decode_bitmatrix(
        matrix_to_bitmatrix(inv[list(lost)], 8), chosen)
    damaged = planes.clone()
    for c in lost:
        damaged[c * 8:(c + 1) * 8] = 0
    rebuilt = q.submit_packedbit_planes(decode, damaged, 8,
                                        len(lost)).result(timeout=120)
    with _uncounted(device):
        rows = lane.from_packedbit(rebuilt, len(lost)).cpu().numpy()
    for i, c in enumerate(lost):
        check(np.array_equal(rows[i, :flat.shape[1]], flat[c]),
              f"submit_packedbit_planes rebuilt chunk {c} wrong")
    emit("lanes packedbit", object_bytes=OBJECT_SIZE, planes=list(planes.shape),
         rebuilt=list(lost), checked=True)

    # the int8-plane lanes: w=8 with the packed-bit lane off, and w=16
    saved = os.environ.get("CEPH_TPU_PACKEDBIT")
    os.environ["CEPH_TPU_PACKEDBIT"] = "0"
    try:
        for w in (8, 16):
            cdc = (codec if w == 8 else
                   _codec("cuda", device, technique="reed_sol_van", k=8, m=3,
                          w=16))
            cpu = _codec("jerasure", "cpu", technique="reed_sol_van", k=8,
                         m=3, w=w)
            before = q.perf.get("submit_packed")
            got = ecutil.batched_encode(cdc, sinfo, obj, queue=q)
            check(q.perf.get("submit_packed") == before + 1,
                  f"w={w} write did not take the packed lane")
            want = (shards if w == 8 else ecutil.batched_encode(cpu, sinfo, obj))
            check(all(np.array_equal(a, b) for a, b in zip(got, want)),
                  f"w={w} write through `submit` differs from CPU jerasure")
            wparity = np.stack(want[8:])
            bmw = matrix_to_bitmatrix(cdc.matrix, w)
            bits = lane.unpack_bits_bytes(data, w)
            planar = q.submit_planar(bmw.astype(np.int8), bits, w,
                                     3).result(timeout=120)
            res_parity, res_bits = q.submit_resident(
                bmw.astype(np.int8), flat, w, 3).result(timeout=120)
            with _uncounted(device):
                mb = lane.bitmatrix_to_tensor(bmw, device)
                check(torch.equal(planar, lane.gf2_matmul(mb, bits)),
                      f"w={w} submit_planar differs from gf2_matmul")
                check(torch.equal(res_bits, lane.gf2_encode_resident(
                    mb, data, w, 3)[1]),
                      f"w={w} submit_resident planes differ")
            check(np.array_equal(lane.pack_bits_bytes(planar, w, 3)
                                 .cpu().numpy(), wparity),
                  f"w={w} submit_planar parity differs from CPU jerasure")
            check(np.array_equal(res_parity, wparity),
                  f"w={w} submit_resident parity differs from CPU jerasure")
            emit("lanes int8", w=w, packed=True, planar=True, resident=True,
                 checked=True)
    finally:
        if saved is None:
            os.environ.pop("CEPH_TPU_PACKEDBIT")
        else:
            os.environ["CEPH_TPU_PACKEDBIT"] = saved


# ---------------------------------------------------------------- phase 4 --

def phase_split(device) -> None:
    """Where one 4 MiB reed_sol_van k=8 m=3 encode spends its time."""
    import torch

    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
    from ceph_tpu_torch.ops.gf2 import gf2_apply_packedbit

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    obj = np.random.default_rng(SEED + 1).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    bm = matrix_to_bitmatrix(codec.matrix, 8)
    parts = {"host_prepare_ms": [], "h2d_ms": [], "kernel_call_ms": [],
             "d2h_ms": [], "encode_total_ms": []}
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        chunks = codec.encode_prepare(obj, codec.get_chunk_size(len(obj)))
        t1 = time.perf_counter()
        dev = torch.from_numpy(chunks).to(device)
        sync(device)
        t2 = time.perf_counter()
        out = gf2_apply_packedbit(bm, dev)
        sync(device)
        t3 = time.perf_counter()
        out.cpu().numpy()
        t4 = time.perf_counter()
        codec.encode(set(range(11)), obj)
        t5 = time.perf_counter()
        for key, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4),
                                       (t4, t5))):
            parts[key].append((b - a) * 1e3)
    split = {k: statistics.median(v) for k, v in parts.items()}
    print("split " + json.dumps(split))

    # device busy share of back-to-back encodes: every kernel and copy the
    # profiler traced on the card, against the wall time of the window
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TIMING_REPS):
            codec.encode(set(range(11)), obj)
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_card = {e.key: e.self_device_time_total / 1e3
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    device_ms = sum(on_card.values())
    print("profile " + json.dumps({
        "encodes": TIMING_REPS, "wall_ms": wall_ms, "device_ms": device_ms,
        "device_busy_share": device_ms / wall_ms if device_ms else None,
        "device_ms_by_name": dict(sorted(on_card.items(),
                                         key=lambda kv: -kv[1])[:6])}))


# ------------------------------------------------------------------ main --

def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import ceph_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: ceph_tpu_torch is not importable beside this "
              f"script: {e}", file=sys.stderr)
        return 2
    try:
        card = card_line()
        print(f"card: {card}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        phase_build()
        rows = phase_kernels("cuda")
        counts, routes = phase_main("cuda")
        for name, n in phase_queue("cuda", card).items():
            counts[name]["queue"] = n
        phase_split("cuda")
        kernels = []
        for name, (source, replaces) in KERNEL_META.items():
            row = rows[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": sum(counts[name].values()),
                "launches_by_run": counts[name],
                "max_abs_err": row["max_abs_err"], "match": True,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"],
                "path": row["path"]})
        for row in kernels:
            name = row["name"]
            if name + ".popc" in rows:
                row.update(paths=routes[name],
                           popc_ms=rows[name + ".popc"]["ms"])
            row.update({key: rows[name][key] for key in
                        ("groups", "steps", "warps_per_sm", "words")
                        if key in rows[name]})
            if name == "apply_packedbit":
                row.update(ms_turns=rows[name]["ms_turns"],
                           apply_bytes_w8_ms_turns=rows[name][
                               "apply_bytes_w8_ms_turns"])
        torch.cuda.synchronize()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
