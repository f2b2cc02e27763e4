#!/usr/bin/env python3
"""Drive ceph_tpu_torch on one CUDA card and check everything it prints.

    python3 chip_smoke.py          # from the repository root, one card

Phases; any failure exits nonzero before the result line is printed:

1. build    nvcc builds every kernel library from ceph_tpu_torch/ops/csrc
            (one nvcc per source, all started together) and g++ the port's
            crc32c library, native GF(2^8) core, wirepath library and wirepy
            shim beside them; seconds and ptxas register/spill lines are
            printed.
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
5. store    device residency, the OSD's resident write and read path, at
            the OSD's layout and shared_planar_store's defaults (a 256 MiB
            PagedResidentStore of 64 KiB pages on CUDA sub-slabs; a 4 MiB
            object is 88 pages, so 46 fit), one BatchingQueue with the 50 ms
            window, every launch count set to 0 just before and read just
            after (the "store" run):
            a. 64 writes through ecutil.planar_encode_async, each product
               installed with the OSD's put_planar call, in turns with
               batched_encode_async (resident, batched, batched, resident);
               every shard list against the CPU plugin=jerasure; every
               install device-native, 18 evictions;
            b. planar_object_bytes of every object (the 46 residents equal
               their objects, the evicted ones None; each read one launch
               of from_packedbit_paged; a second read from the memo),
               planar_rows and planar_shard_bytes, a resident read (memo
               cleared) in turns with a degraded read through the queue
               and in turns with the gather path it replaced (slab_gather,
               K6, pageable copy, host de-interleave) called by hand, a
               read's parts, and
               object reads after shed_parity; slab_gather must not be
               called by any of the port's reads;
            c. an admit of one object's 11 shard rows into the paged store
               (to_packedbit_paged, one launch) read back; a
               PlanarShardStore: chunks 1, 5, 9 rebuilt from the resident
               planes by apply (K3), and admit (K5) then read (K6);
            d. four w=16 objects through the int8-plane resident lane (K2)
               into a paged store, gathered as int8 planes;
            e. writes installed from a side stream while reads gather in one
               event loop.
            K2-K6 and the two paged kernels must each launch.  Then
            slab_install of 88 pages and slab_gather of 64, against a CPU
            sub-slab, timed beside a copy of the same bytes; and the paged
            kernels at the store's shapes (from_packedbit_paged: a [64,
            16384] object read with cs = 4096 and [88, 16384] shard rows;
            to_packedbit_paged: an [11, 524288] admit into 88 pages), on
            pages scattered over two sub-slabs, against their plain
            versions byte for byte, timed in turns with the composition
            each replaced (slab_gather and K6; K5, the page image and
            slab_install),
            beside a copy of the same bytes and the bound (K5 and K6 at
            the store's shapes are timed in phase 2), and the host ms of
            building one resident's page table.  Each line is "store
            {...}" with the card's name and power limit.
6. osd      the OSD daemon path: an in-process vstart cluster of one mon
            and 12 OSDs (MemStore) at the default EC device conf (batching
            on, residency on, a 256 MiB paged store of 64 KiB pages on its
            device arm, the 2 ms window), one plugin=cuda reed_sol_van k=8
            m=3 pool, every launch count set to 0 just before and read just
            after (the "osd" run):
            a. 64 seeded 4 MiB puts, 8 in flight; every object's 11 stored
               shards and HashInfo against the CPU plugin=jerasure through
               ecutil.batched_encode; objects/s, GB/s, client ms p50/p99,
               the primaries' write ops step by step (p50/p99 µs of the
               gap between adjacent events of their timelines), and the
               device's busy share (torch.profiler) over 16 of the
               objects put again;
            b. every object read back byte for byte: GB/s, ms p50/p99, how
               many were served from residents and how many shard sub-reads
               were made, and the read ops step by step;
            c. the OSD in the most PGs' acting sets killed and marked down,
               every object read again (degraded): GB/s, ms p50/p99, and
               the read ops step by step;
            d. repair_pool (recovery is left to it: osd_auto_repair off)
               until every object has its 11 shards again, seconds and
               bytes pushed; a second OSD killed, every object read again;
            e. the ec_cuda, ec_plugin, gf2_sched and pagestore counters,
               the osd and tier counters summed over the 12 OSDs, and the
               op tracker's phase percentiles over the live OSDs.
            The queue and the store must be on the card, the plugin's
            cpu_fallback and device_failed and the queue's breaker_fallback
            0, apply_packedbit (K4) and from_packedbit_paged must launch and
            the store must count device installs.  The queue and store are
            one per process, shared by the 12 OSDs.  Each line is "osd
            {...}" with the card's name and power limit.
7. codecs   the CPU codec plugins on the port's native core, and the
            layered codecs and an isa pool on the card:
            a. isa k=8 m=3 and jerasure k=8 m=3 and k=4 m=2 parity of a
               4 MiB object against the numpy GF(2^8) oracle, then the
               benchmark CLI on BASELINE.md's five configurations (jerasure
               reed_sol_van k=4 m=2, isa reed_sol_van k=8 m=3, jerasure
               cauchy_good k=10 m=4, lrc k=4 m=2 l=3, clay k=8 m=4 d=11) at
               4 MiB, encode and a 2-erasure decode, on this machine's CPU:
               GB/s beside the CPU model, its thread count and the native
               core's region kernel (gfni, avx2 or scalar);
            b. lrc k=4 m=2 l=3 in its explicit form with three plugin=cuda
               layers, and clay k=8 m=4 d=11 scalar_mds=cuda, built on the
               card through the registry, with every launch count set to 0
               just before and read just after (the "codecs" run): every
               chunk, a 2-erasure decode and clay's sub-chunk repair of one
               chunk against the jerasure-layered CPU codecs, K4's launches
               per encode, decode and repair, and the CLI's GB/s for each;
            c. phase 6 again with a plugin=isa reed_sol_van k=8 m=3 pool and
               16 objects (the "osd-isa" run): every stored shard and
               HashInfo against the CPU isa codec, apply_packedbit and
               from_packedbit_paged launched, no fallback.  Each line is
               "codecs {...}" or "osd-isa {...}" with the card's name and
               power limit.
8. clients  the client APIs and the mgr on the daemon path: a vstart cluster
            of one mon, 12 OSDs (MemStore, the default EC device conf) and
            the mgr (OSDs report every third 0.2 s ping), one plugin=cuda
            reed_sol_van k=8 m=3 pool of 16 PGs reached through librados,
            every launch count set to 0 just before and read just after
            (the "clients" run):
            a. a 64 MiB RBD image (16 objects of 4 MiB, order=22) written
               by one Image.write (16 write_fulls, one at a time) and read
               whole: GB/s;
            b. 16 seeded 64 KiB writes inside objects, each the OSD's
               read-modify-write (rmw_partial must count 16): ms p50/p99;
            c. snap_create, 4 writes after it, read_snap of the snapshot:
               GB/s;
            d. export_image of the snapshot and export_diff from it to the
               head, import_image and apply_diff into a second image,
               which must equal the first: MB/s of each side;
            e. a RadosStriper round trip of a 24 MiB object: GB/s;
            f. the OSD in the most acting sets killed, the image read
               degraded: GB/s;
            g. once every live OSD has reported after the last op, /metrics
               scraped over the mgr's HTTP port: every live OSD's
               ceph_ec_cuda_dispatch equals the queue's own dispatch count
               (above 0), and ceph_health_status is present.
            Every read is held against a model of the image.  The queue and
            store must be on the card, no fallback counted, and K4 and the
            paged K6 must launch.  Each line is "clients {...}" with the
            card's name and power limit.
9. services the object gateway and CephFS on the daemon path: phase 8's
            cluster (12 OSDs, the mgr, the default EC device conf), its
            plugin=cuda k=8 m=3 pool of 16 PGs as the data pool and a
            replicated metadata pool, every launch count set to 0 just
            before and read just after (the "services" run):
            a. RGW on the data pool with 4 MiB stripes (rgw_obj_stripe_size),
               through its HTTP frontend with SigV4 as a user RgwAdmin
               made: 16 PUTs of 4 MiB (the bucket index is the EC pool's
               client-side read-modify-write: its write_fulls per PUT are
               counted), a multipart upload of 4 parts of 8 MiB, a LIST,
               16 GETs, 16 range GETs of 1 MiB and the multipart GET: GB/s
               and range ms p50/p99, and a PUT's and a GET's data-pool ops
               by method and object (stripe piece, striper header, index,
               datalog, bucket meta): count and ms a request;
            b. CephFS: MDSCluster(n_ranks=2) over the metadata and data
               pools through CephFSMultiClient, /d1 exported to rank 1
               (ms), 8 files of 8 MiB written and read (GB/s), a snapshot
               and a write after it, a rename across ranks, replace_rank(1)
               (its journal replay, ms);
            c. the OSD in the most acting sets lost, every object and file
               read again (degraded GB/s).
            Every read is held against a seeded model.  The queue and store
            must be on the card, no fallback counted, K4 and the paged K6
            must launch; slab_install and slab_gather calls are counted.
            Each line is "services {...}" with the card's name and power
            limit.
10. tools   the offline and operator tools, with every launch count set to
            0 just before and read just after (the "tools" run; only this
            process's launches count):
            a. corpus: the port's non_regression --check of every
               corpus/plugin=* archive with its own plugin, the plugin=tpu
               one under plugin=cuda with CEPH_TPU_PACKEDBIT=1 and =0; then
               --create of plugin=cuda and plugin=jerasure reed_sol_van k=8
               m=3 and cauchy_good k=4 m=2 into a temp --base, their chunks
               equal, and --check of the cuda ones on both lanes;
            b. sweep: bench_suite over jerasure, isa and cuda at 4 MiB, 4
               iterations, its default (k, m) map (132 cells): each cell's
               MB/s, the plugins side by side;
            c. gates: the ten cluster gates of non_regression, each a
               process with --device cuda at its default seconds: rc and
               wall seconds, and the slab parity children's store counters;
            d. operator tools on a disk-backed 4-OSD cluster with the mgr
               and a plugin=cuda k=2 m=1 pool of 4 MiB objects: ceph status,
               health, osd df and osd tree, trace_export of one put's
               trace, objectstore_tool --op list on a stopped OSD's store,
               monstore_tool dump of the stopped mon's, dencoder roundtrip,
               ceph_volume prepare/list/zap, cephadm bootstrap --device
               cuda, ls and rm-cluster;
            e. lint: python -m ceph_tpu_torch.tools.lint --json, ok with 0
               findings.
            K4, K1 and K3 must launch.  Each line is "tools {...}" with the
            card's name and power limit.
11. wire    the native wire path, with every launch count set to 0 just
            before and read just after (the "wire" run):
            a. the port resolves the native arm (wirepath.kind() ==
               "native"; anything else fails the phase) and the library's
               selftest returns 0;
            b. every wire_* and wirepy_* entry point against the python arm
               (the process checksum a segment, joins, slices) on 12 frames
               of the committed corpus/wire, each cut into awkward segments;
            c. two of the port's messengers over TCP, ms_wirepath_native on
               and off in turns (native, python, python, native), 48 seeded
               messages of up to 1 MiB, with injected socket failures and
               duplicated frames and then without: dispatch exactly once,
               in order, the same bytes; native_tx_calls > 0 only on the
               native turns; MB/s of each turn on the card host's CPU.  Then
               a pair with ms_reactor_mode=process, forked from this
               process while it holds a CUDA context: striped messages
               through the workers exactly once and in order;
            d. the osd phase's 12-OSD plugin=cuda k=8 m=3 cluster over TCP
               (ms_local_fastpath off, as the --wire-floor gate runs it), a
               cluster a turn in the same turns, 16 seeded 4 MiB puts and
               gets, 8 in flight: put and get GB/s, the p50 of a put's
               encoded->sub_writes_sent step, wirepath_kind and
               native_tx_calls of every messenger, every read checked.
            Each line is "wire {...}" with the card's name and power limit.
12. mesh    the batching queue on a mesh: CEPH_TPU_MESH=1 on a host with one
            card lays each dispatch over 8 shards of it (every shard on the
            card, or the phase fails), with every launch count set to 0
            just before and read just after (the "mesh" run):
            a. the six lanes on one 4 MiB k=8 m=3 object's rows through a
               queue on the mesh (packedbit, packedbit_resident and
               packedbit_planes with the packed-bit lane on; packed,
               resident and planar with CEPH_TPU_PACKEDBIT=0): each equal
               byte for byte to a mesh=False queue's (launches uncounted)
               and to the CPU plugin=jerasure's shards, one sharded
               dispatch each, one launch of its kernel (K4, K3, K1, K2) a
               shard;
            b. 64 seeded 4 MiB writes through ecutil into the mesh queue and
               a mesh=False queue in turns (mesh, single, single, mesh):
               GB/s of each, their ratio, and K4 launches of the mesh turns
               (one a shard a dispatch);
            c. tests/test_mesh.py's case on the card: a 3-OSD cluster with
               concurrent puts of 12 objects of 50,000 bytes; the puts
               coalesce, every dispatch rides the mesh (one launch a shard)
               and every get reads back.
            Each line is "mesh {...}" with the card's name and power limit.
13. split   host prepare / host->device / kernel call (apply_packedbit,
            the lane's one launch) / device->host of one 4 MiB encode (the
            codec API takes host bytes), and the device's busy share over
            back-to-back encodes from torch.profiler.
14. report  the card, one {"kernels": [...]} line (each row's "launches" is
            the sum of its counts in phases 3 to 12, "launches_by_run" the
            thirteen runs), and the result line.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
    "to_packedbit_paged": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
                           "ceph_tpu/ops/gf2.py:576"),
    "from_packedbit_paged": ("ceph_tpu_torch/ops/csrc/packedbit.cu",
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
    import threading

    from ceph_tpu_torch.native import bridge
    from ceph_tpu_torch.ops import build
    from ceph_tpu_torch.utils import checksum

    t0 = time.perf_counter()
    host_s = {}
    errors = []

    def gxx(name, fn):  # g++ of a host library beside the nvcc builds
        try:
            fn()
            host_s[name] = time.perf_counter() - t0
        except Exception as e:
            errors.append(f"{name}: {e}")

    host = [threading.Thread(target=gxx, args=item) for item in (
        ("crc32c", checksum.build), ("native GF core", bridge.build),
        ("wirepath library", bridge.build_wire),
        ("wirepy shim", bridge.build_wirepy))]
    for t in host:
        t.start()
    results = build.build_all()
    for t in host:
        t.join()
    check(not errors, "a host library did not build: " + "; ".join(errors))
    check(checksum.checksum_kind() == "crc32c",
          "the port's crc32c library did not build")
    print(f"build: {time.perf_counter() - t0:.2f}s total "
          f"({', '.join(f'{n} {s:.2f}s' for n, (s, _) in results.items())}"
          f", {', '.join(f'{n} {s:.2f}s' for n, s in host_s.items())}"
          f"; each time from the start of the build)")
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


def phase_kernels(device, card):
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
            print("kernel " + json.dumps({**line, "card": card}))
            if report:
                rows[name if r == order[0] else name + ".popc"] = dict(line)
        if turns:
            n = (in_bytes + out_bytes) // 2  # read n and write n: the kernel's bytes
            src = torch.empty(n, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            print("floor " + json.dumps({
                "kernel": name, "shape": label, "copy_bytes": n,
                "ms": time_ms(lambda: dst.copy_(src), TIMING_REPS),
                "card": card}))
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
    phase_packedbit(device, bms, rng, rows, card)
    return rows


def phase_packedbit(device, bms, rng, rows, card) -> None:
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
        print("kernel " + json.dumps({**line, "card": card}))
        if report:
            rows[name] = line
        if floor:
            n = n_bytes // 2  # read n and write n: the kernel's bytes
            src = torch.empty(n, dtype=torch.uint8, device=device)
            dst = torch.empty_like(src)
            print("floor " + json.dumps({
                "kernel": name, "shape": label, "copy_bytes": n,
                "ms": time_ms(lambda: dst.copy_(src), TIMING_REPS),
                "card": card}))
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
    print("turns " + json.dumps({"shape": main["shape"], **turns,
                                 "card": card}))
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

    # the store's shapes first (an admit of an object's 11 chunks; a read
    # of its 8 data chunks and of all 11), then the codec's and 2 MiB
    k5(rand(np.uint8, (11, main_cols)), "", timed=True, report=True,
       floor=True)
    k5(rand(np.uint8, (8, main_cols)), "", timed=True, floor=True)
    k5(rand(np.uint8, (8, BATCH_COLS)), "", timed=True)
    for B in (1, 31, 1000):
        k5(rand(np.uint8, (8, B)), "")
    k5(rand(np.uint8, (8, 4096), offset=1), " base+1")
    k6(rand(np.int32, (64, main_cols // 32)), "", timed=True, report=True,
       floor=True)
    k6(rand(np.int32, (88, main_cols // 32)), "", timed=True, floor=True)
    k6(rand(np.int32, (24, main_cols // 32)), "", timed=True, floor=True)
    k6(rand(np.int32, (24, BATCH_COLS // 32)), "", timed=True)
    for W in (1, 31):
        k6(rand(np.int32, (24, W)), "")
    k6(rand(np.int32, (24, 1000), offset=1), " base+4")


# ---------------------------------------------------------------- phase 3 --

def _bench(argv):
    """One benchmark CLI run: (seconds, KB, GB/s of object data, its line)."""
    from ceph_tpu_torch.tools import benchmark

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(argv)
    text = out.getvalue().strip()
    check(rc == 0, f"benchmark {' '.join(argv)} exited {rc}")
    seconds, kb = text.split("\t")
    return float(seconds), int(kb), int(kb) * 1024 / float(seconds) / 1e9, text


def _run_cli(argv, label):
    """One benchmark CLI run; prints its rate and what the schedule LRU did
    in it (gf2_sched deltas: hits, misses, seconds spent compiling)."""
    from ceph_tpu_torch.ops.gf2 import SCHED_PERF

    before = SCHED_PERF.dump()
    seconds, _, gbps, text = _bench(argv)
    after = SCHED_PERF.dump()
    print(f"cli {label}: {text!r} -> {gbps:.3f} GB/s of object data")
    compile_s = after["compile_s"]["sum"] - before["compile_s"]["sum"]
    print("sched " + json.dumps({
        "cli": label, "seconds": seconds,
        **{k: after[k] - before[k] for k in ("hit", "miss", "compile")},
        "compile_s": compile_s, "compile_share": compile_s / seconds}))


def _codec(plugin: str, device, **profile):
    """A codec through the registry on `device`, as the benchmark CLI
    resolves it (host plugins ignore the device)."""
    from ceph_tpu_torch.ec.registry import registry

    profile = {"plugin": plugin, **{k: str(v) for k, v in profile.items()}}
    return registry.factory(plugin, "", profile, device=device)


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
            "from_packedbit": cuda_packedbit.from_packedbit,
            "to_packedbit_paged": cuda_packedbit.to_packedbit_paged,
            "from_packedbit_paged": cuda_packedbit.from_packedbit_paged}


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


@contextlib.contextmanager
def _env(**values):
    """Environment variables set inside, put back as they were after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


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

    with _env(CEPH_TPU_PACKEDBIT="0"):
        _zero_counts()
        _codec_path(device)
        off, routes = _read_counts(device, "(CEPH_TPU_PACKEDBIT=0)")
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


@contextlib.contextmanager
def _counting(module, name: str, calls: list):
    """Count the calls of module.<name> inside into calls[0]."""
    real = getattr(module, name)

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    setattr(module, name, counted)
    try:
        yield
    finally:
        setattr(module, name, real)


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
    with _env(CEPH_TPU_PACKEDBIT="0"):
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


# ------------------------------------------------------------ phase store --

# shared_planar_store's defaults: the OSD's resident budget and page size
STORE_BYTES = 256 << 20
STORE_PAGE = 64 << 10
STORE_W16_OBJECTS = 4        # w=16 residents (int8 planes, K2)
STORE_MIXED = 16             # writes and reads of the concurrent step


def _forget_memo(store, keys=None) -> None:
    """Empty the paged store's exit-boundary memo (of `keys`, or all), so
    that the next object read gathers from the pages."""
    with store._lock:
        for key in list(store._memo) if keys is None else keys:
            store._memo_discard(key)


def lost_rows_bitmatrix(codec, lost):
    """A [len(lost)*8, 88] bit-matrix over the planes of all 11 chunks that
    rebuilds the `lost` chunks, data or parity, from the codec's chosen
    survivors: a parity chunk's rows are its generator rows composed with
    the decode matrix (bit-matrices compose as their GF(2^8) matrices)."""
    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix

    chosen, inv = codec.decode_selection(set(lost), set(range(11)) - set(lost))
    binv = matrix_to_bitmatrix(inv, 8).astype(np.int64)
    gen = matrix_to_bitmatrix(codec.matrix, 8).astype(np.int64)
    rows = [binv[c * 8:(c + 1) * 8] if c < 8
            else gen[(c - 8) * 8:(c - 7) * 8] @ binv % 2 for c in lost]
    return resident_decode_bitmatrix(np.vstack(rows).astype(np.uint8), chosen)


def phase_store(device, card):
    """Device residency, the OSD's resident write and read path, on the
    card: ecutil's planar helpers, the paged store on CUDA sub-slabs and
    PlanarShardStore, at the OSD's layout and shared_planar_store's
    defaults.  Returns each kernel's launch count in this run; then times
    the slab ops beside a copy of the same bytes (uncounted)."""
    import asyncio

    import torch

    from ceph_tpu_torch.ops import cuda_packedbit
    from ceph_tpu_torch.ops import slab as slab_ops
    from ceph_tpu_torch.parallel.service import BatchingQueue, PlanarShardStore
    from ceph_tpu_torch.rados import ecutil
    from ceph_tpu_torch.rados.pagestore import PagedResidentStore

    def emit(step, **numbers):
        print("store " + json.dumps({"step": step, **numbers, "card": card}))

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    cpu = _codec("jerasure", "cpu", technique="reed_sol_van", k=8, m=3)
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * STRIPE_UNIT)
    k, cs, n = 8, STRIPE_UNIT, QUEUE_OBJECTS
    rng = np.random.default_rng(SEED + 4)
    objs = [rng.integers(0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
            for _ in range(n)]
    k6 = cuda_packedbit.from_packedbit
    paged = cuda_packedbit.from_packedbit_paged
    # slab_gather calls made by the port's resident reads: none
    read_gathers = [0]
    q = BatchingQueue(device=device, max_delay=WIDE_WINDOW_S)
    store = PagedResidentStore(STORE_BYTES, STORE_PAGE, queue=q, device=device)
    check(store.device_arm, "the paged store is not on its device arm")
    # 11 chunks x 8 planes x 16384 words: one page a plane row
    obj_pages = 11 * 8 * (OBJECT_SIZE // k // 32) * 4 // STORE_PAGE
    fit = store.pages_total // obj_pages

    def install(key, product, target=None):
        _, bits, n_rows, n_cols, w = product
        return (target or store).put_planar(
            key, bits, w=w, n_rows=n_rows, meta=(1, n_cols, OBJECT_SIZE),
            trim=n_cols, data_rows=k * w)  # the OSD's call (osd.py:5320)

    async def resident_writes(keys):
        async def one(key, i):
            product = await ecutil.planar_encode_async(codec, sinfo, objs[i],
                                                       queue=q)
            check(install(key, product), f"store refused object {key}")
            return product[0]

        return await asyncio.gather(*(one(key, i) for key, i in keys))

    async def batched_writes():
        return await asyncio.gather(*(ecutil.batched_encode_async(
            codec, sinfo, o, queue=q) for o in objs))

    _zero_counts()
    try:
        # 1. resident writes, in turns with batched queue writes
        want, ms = None, {"resident": [], "batched": []}
        for arm in ("resident", "batched", "batched", "resident"):
            t0 = time.perf_counter()
            got = asyncio.run(resident_writes([(i, i) for i in range(n)])
                              if arm == "resident" else batched_writes())
            ms[arm].append((time.perf_counter() - t0) * 1e3 / n)
            if want is None:
                want = got
                for i in range(n):
                    same = all(np.array_equal(a, b) for a, b in zip(
                        got[i], ecutil.batched_encode(cpu, sinfo, objs[i])))
                    check(len(got[i]) == 11 and same,
                          f"resident write {i} differs from CPU jerasure")
                d = store.perf.dump()
                check(d["device_installs"] == n and d["h2d_installs"] == 0,
                      f"installs: {d['device_installs']} device-native, "
                      f"{d['h2d_installs']} from the host, of {n}")
                check(d["evict"] == n - fit and d["entries"] == fit
                      and d["pages_used"] == fit * obj_pages,
                      f"residency: {d['evict']} evictions, {d['entries']} "
                      f"entries, {d['pages_used']} pages for {n} objects of "
                      f"{obj_pages} pages in {store.pages_total}")
            else:
                check(all(all(np.array_equal(a, b) for a, b in zip(x, y))
                          for x, y in zip(got, want)),
                      f"{arm} writes differ from the first turn")
        d = store.perf.dump()
        check(d["device_installs"] == 2 * n and d["h2d_installs"] == 0,
              "a queue product crossed from the host")
        emit("writes", objects=n, object_bytes=OBJECT_SIZE,
             pages_an_object=obj_pages, objects_that_fit=fit,
             resident_write_ms_an_object_turns=ms["resident"],
             batched_write_ms_an_object_turns=ms["batched"],
             against_cpu_jerasure=n)
        # the device's share of one profiled turn of resident writes
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            asyncio.run(resident_writes([(i, i) for i in range(n)]))
            sync(device)
            wall_us = (time.perf_counter() - t0) * 1e6
        busy = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.lower()
                kind = ("copy" if "memcpy" in name else "fill"
                        if "memset" in name or "fill" in name else "kernel")
                busy[kind].append((e.time_range.start, e.time_range.end))
        check(busy["kernel"], "the profiler saw no kernel on the card")
        busy_us = sum(b - a for a, b in _interval_union(
            [iv for v in busy.values() for iv in v]))
        emit("writes profiled", objects=n, wall_ms=wall_us / 1e3,
             device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
             **{f"{kind}_ms": sum(b - a for a, b in v) / 1e3
                for kind, v in busy.items()},
             events={kind: len(v) for kind, v in busy.items()})

        # 2. reads: resident objects from their pages, evicted ones None
        resident = [i for i in range(n) if i in store]
        check(len(resident) == fit, f"{len(resident)} residents, not {fit}")
        _forget_memo(store)
        launches0, k6_0, d2h0 = paged.launches, k6.launches, store.d2h_gathers
        with _counting(slab_ops, "slab_gather", read_gathers):
            for i in range(n):
                got = ecutil.planar_object_bytes(store, i, 1, k, cs,
                                                 OBJECT_SIZE)
                check(got == (objs[i] if i in resident else None),
                      f"resident read of object {i}")
        exits = store.d2h_gathers - d2h0
        check(exits == fit and paged.launches - launches0 == fit
              and k6.launches == k6_0,
              f"{fit} resident reads made {exits} device->host exits, "
              f"{paged.launches - launches0} paged K6 launches and "
              f"{k6.launches - k6_0} K6 launches")
        launches0, d2h0 = paged.launches, store.d2h_gathers
        for i in resident:
            check(ecutil.planar_object_bytes(store, i, 1, k, cs, OBJECT_SIZE)
                  == objs[i], f"memo read of object {i}")
        check(store.d2h_gathers == d2h0 and paged.launches == launches0,
              "a second read was not served from the memo")
        with _counting(slab_ops, "slab_gather", read_gathers):
            for i in resident[:4]:
                rows = ecutil.planar_rows(store, i, 1)
                check(rows is not None and all(
                    np.array_equal(a, b) for a, b in zip(rows, want[i])),
                      f"planar_rows of object {i}")
            for i in resident[4:6]:
                for shard in range(11):
                    check(ecutil.planar_shard_bytes(store, i, 1, shard)
                          == np.asarray(want[i][shard]).tobytes(),
                          f"planar_shard_bytes of object {i} shard {shard}")
        ms = {"resident": [], "degraded": [], "gather": []}
        blobs = {i: {c: s for c, s in enumerate(want[i]) if c not in LOST}
                 for i in resident}

        async def degraded():
            return await asyncio.gather(*(ecutil.decode_object_async(
                codec, sinfo, blobs[i], OBJECT_SIZE, queue=q)
                for i in resident))

        def resident_reads():
            with _counting(slab_ops, "slab_gather", read_gathers):
                return [ecutil.planar_object_bytes(store, i, 1, k, cs,
                                                   OBJECT_SIZE)
                        for i in resident]

        def gather_reads():
            # the gather path the paged read replaced: with read_paged
            # shadowed, ecutil gathers the rows, runs K6, copies them to
            # pageable memory and de-interleaves them on the host
            # (launches uncounted)
            store.read_paged = None
            try:
                with _uncounted(device):
                    return [ecutil.planar_object_bytes(store, i, 1, k, cs,
                                                       OBJECT_SIZE)
                            for i in resident]
            finally:
                del store.read_paged

        for arm in ("resident", "degraded", "degraded", "resident",
                    "resident", "gather", "gather", "resident"):
            _forget_memo(store)
            t0 = time.perf_counter()
            if arm == "resident":
                got = resident_reads()
            elif arm == "gather":
                got = gather_reads()
            else:
                got = asyncio.run(degraded())
            ms[arm].append((time.perf_counter() - t0) * 1e3 / fit)
            check(got == [objs[i] for i in resident], f"{arm} reads")
        emit("read parts", **_read_parts(device, store, resident, k, cs))
        for i in resident[-4:]:
            _forget_memo(store, [i])
            check(store.shed_parity(i) > 0, f"no parity shed from {i}")
            check(ecutil.planar_rows(store, i, 1) is None,
                  f"planar_rows served a shed resident {i}")
            check(ecutil.planar_object_bytes(store, i, 1, k, cs, OBJECT_SIZE)
                  == objs[i], f"read of object {i} after its parity shed")
        check(read_gathers[0] == 0,
              f"the resident reads called slab_gather {read_gathers[0]} times")
        emit("reads", resident=fit, evicted=n - fit,
             resident_read_ms_an_object_turns=ms["resident"][:2],
             degraded_read_ms_an_object_turns=ms["degraded"],
             paged_read_ms_an_object_turns=ms["resident"][2:],
             gather_read_ms_an_object_turns=ms["gather"],
             lost=list(LOST), planar_rows=4, planar_shard_bytes=2,
             parity_sheds=4, slab_gather_calls_on_reads=read_gathers[0])

        # 3. an admit into the paged store (the paged K5) read back; a
        # resident decode (K3 through the queue) and admit (K5) / read
        # (K6) on the monolithic store
        i = resident[0]
        rows = np.stack(want[i])
        k5p, installs = cuda_packedbit.to_packedbit_paged.launches, \
            store.device_installs
        check(store.admit("admitted", rows, layout="packedbit",
                          meta=(1, rows.shape[1], OBJECT_SIZE)),
              "the paged store refused an admit")
        check(cuda_packedbit.to_packedbit_paged.launches == k5p + 1
              and store.device_installs == installs + 1,
              "the admit was not one paged K5 launch and one device install")
        check(np.array_equal(store.read("admitted"), rows),
              "paged admit then read differs")
        check(ecutil.planar_object_bytes(store, "admitted", 1, k, cs,
                                         OBJECT_SIZE) == objs[i],
              "paged admit then object read differs")
        store.drop("admitted")
        emit("paged admit", admitted=list(rows.shape), pages=obj_pages,
             read_back=True)
        pss = PlanarShardStore(STORE_BYTES, queue=q, device=device)
        product = asyncio.run(ecutil.planar_encode_async(codec, sinfo,
                                                         objs[i], queue=q))
        _, bits, n_rows, n_cols, _ = product
        damaged = bits.clone()
        for c in LOST:
            damaged[c * 8:(c + 1) * 8] = 0
        pss.put_planar("object", damaged, w=8, n_rows=n_rows,
                       meta=(1, n_cols, OBJECT_SIZE))
        x0 = cuda_packedbit.xor_schedule.launches
        pss.apply("object", lost_rows_bitmatrix(codec, LOST), len(LOST),
                  out_key="rebuilt")
        check(cuda_packedbit.xor_schedule.launches > x0,
              "the resident decode did not run K3")
        rebuilt = pss.read("rebuilt")
        for j, c in enumerate(LOST):
            check(np.array_equal(rebuilt[j, :n_cols], want[i][c]),
                  f"resident decode rebuilt chunk {c} wrong")
        k5 = cuda_packedbit.to_packedbit.launches
        pss.admit("admitted", rows, layout="packedbit")
        check(cuda_packedbit.to_packedbit.launches == k5 + 1,
              "admit did not run K5 once")
        check(np.array_equal(pss.read("admitted"), rows),
              "admit then read differs")
        emit("planar store", rebuilt=list(LOST), admitted=list(rows.shape),
             **pss.stats())
        del pss, bits, damaged, product

        # 4. w=16: int8 planes through the resident lane (K2)
        codec16 = _codec("cuda", device, technique="reed_sol_van", k=8, m=3,
                         w=16)
        cpu16 = _codec("jerasure", "cpu", technique="reed_sol_van", k=8, m=3,
                       w=16)
        store16 = PagedResidentStore(STORE_BYTES, STORE_PAGE, queue=q,
                                     device=device)
        r0 = q.perf.get("submit_resident")

        async def writes16():
            return await asyncio.gather(*(ecutil.planar_encode_async(
                codec16, sinfo, objs[j], queue=q)
                for j in range(STORE_W16_OBJECTS)))

        for j, product in enumerate(asyncio.run(writes16())):
            check(product[4] == 16 and product[1].dtype == torch.int8,
                  f"w=16 resident {j}: w {product[4]}, {product[1].dtype}")
            check(all(np.array_equal(a, b) for a, b in zip(
                product[0], ecutil.batched_encode(cpu16, sinfo, objs[j]))),
                f"w=16 write {j} differs from CPU jerasure")
            check(install(j, product, store16), f"w=16 resident {j} refused")
        check(q.perf.get("submit_resident") == r0 + STORE_W16_OBJECTS,
              "the w=16 writes did not take the resident lane")
        for j in range(STORE_W16_OBJECTS):
            planes = store16.gather_rows(j, 0, 16)
            check(planes is not None and planes.dtype == torch.int8
                  and planes.device == store16.device, f"w=16 gather {j}")
            check(ecutil.planar_object_bytes(store16, j, 1, k, cs,
                                             OBJECT_SIZE) == objs[j],
                  f"w=16 resident read {j}")
        check(store16.device_installs == STORE_W16_OBJECTS
              and store16.h2d_installs == 0, "w=16 installs crossed the host")
        emit("w16", objects=STORE_W16_OBJECTS, **store16.page_stats())
        del store16

        # 5. writes and reads in one event loop: installs from a side
        # stream land while later rounds run; reads gather on this one
        side = torch.cuda.Stream(device)
        readers = resident[-2 * STORE_MIXED:-STORE_MIXED]
        writers = [j for j in range(n) if j not in resident][:STORE_MIXED]
        for j in readers:
            store.touch(j)  # the newest: the writes evict older residents

        async def write(j):
            product = await ecutil.planar_encode_async(codec, sinfo, objs[j],
                                                       queue=q)
            with torch.cuda.stream(side):
                check(install(("mixed", j), product),
                      f"store refused mixed write {j}")

        async def read(j):
            for _ in range(3):
                await asyncio.sleep(0)
                _forget_memo(store, [j])
                with _counting(slab_ops, "slab_gather", read_gathers):
                    got = ecutil.planar_object_bytes(store, j, 1, k, cs,
                                                     OBJECT_SIZE)
                check(got == objs[j], f"concurrent read of object {j}")

        async def mixed():
            await asyncio.gather(*(write(j) for j in writers),
                                 *(read(j) for j in readers))

        asyncio.run(mixed())
        for j in writers:
            check(ecutil.planar_object_bytes(store, ("mixed", j), 1, k, cs,
                                             OBJECT_SIZE) == objs[j],
                  f"read after a side-stream install of object {j}")
        check(read_gathers[0] == 0, "a concurrent read called slab_gather")
        emit("concurrent", writes=len(writers), reads=3 * len(readers),
             install_stream="side", read_stream="current")
        d = store.perf.dump()
        emit("counters", **{key: (v["avgcount"] if isinstance(v, dict) else v)
                            for key, v in d.items()},
             pack_s_avg=store.perf.avg("pack_s"),
             unpack_s_avg=store.perf.avg("unpack_s"))
        check(d["h2d_installs"] == 0, "a queue product crossed from the host")
    finally:
        q.close()
    counts, _ = _read_counts(device, "(store)")
    for name in ("gf2_matmul", "xor_schedule", "apply_packedbit",
                 "to_packedbit", "from_packedbit", "to_packedbit_paged",
                 "from_packedbit_paged"):
        check(counts[name] > 0, f"{name} never launched in the store run")
    emit("slab_gather on reads", calls=read_gathers[0])
    _time_slab_ops(device, emit)
    return counts, _time_paged_kernels(device, emit, obj_pages)


def _read_parts(device, store, keys, k: int, cs: int) -> dict:
    """Host milliseconds, medians over `keys`, of a resident read's parts,
    each ended by a synchronize so that it holds its device work: the paged
    K6 from the pages to the object's stripe-major bytes, the copy into
    pinned memory, and the bytes made from it; then, on the same residents,
    the parts of the gather path it replaced: the gather of the data rows
    from the pages, K6 on them, the pageable device->host copy of the
    bytes, and the host's de-interleave into the object.  The launches are
    not counted."""
    import torch

    from ceph_tpu_torch.ops.cuda_packedbit import from_packedbit_paged
    from ceph_tpu_torch.ops.gf2 import from_packedbit

    parts = {"paged_k6_ms": [], "pinned_d2h_ms": [], "bytes_ms": [],
             "gather_ms": [], "k6_ms": [], "d2h_ms": [],
             "de_interleave_ms": []}
    with _uncounted(device):
        for key in keys:
            _, _, meta = store.entry_info(key)
            L, size = meta[1], meta[2]
            with store._lock:
                e = store._entries[key]
                table, cols = e.table, e.cols
            t = [time.perf_counter()]
            out = from_packedbit_paged(table, 0, cols, k, L, cs, size)
            sync(device)
            t.append(time.perf_counter())
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            sync(device)
            t.append(time.perf_counter())
            data = host.numpy().tobytes()
            t.append(time.perf_counter())
            bits = store.gather_rows(key, 0, k * 8)
            sync(device)
            t.append(time.perf_counter())
            out = from_packedbit(bits, k)
            sync(device)
            t.append(time.perf_counter())
            rows = out[:, :L].cpu().numpy()
            t.append(time.perf_counter())
            old = rows.reshape(k, L // cs, cs).transpose(1, 0, 2).reshape(
                -1)[:size].tobytes()
            t.append(time.perf_counter())
            check(len(data) == size and old == data, f"read parts of {key}")
            for name, a, b in zip(parts, t, t[1:]):
                parts[name].append((b - a) * 1e3)
    return {"objects": len(keys),
            **{name: statistics.median(v) for name, v in parts.items()}}


def _time_slab_ops(device, emit) -> None:
    """slab_install of one object's 88 pages and slab_gather of its 64 data
    pages, each against a CPU sub-slab, CUDA-event medians with the L2
    flushed, beside a copy of the same bytes and the bytes' bound (K5 and
    K6 at the store's shapes are phase 2's kernel and floor lines)."""
    import torch

    from ceph_tpu_torch.ops.slab import new_subslab, slab_gather, slab_install

    words = STORE_PAGE // 4
    rng = np.random.default_rng(SEED + 5)
    slab = new_subslab(256, words, torch.device(device))
    plain = new_subslab(256, words, torch.device("cpu"))
    for name, n in (("slab_install", 88), ("slab_gather", 64)):
        idx = rng.permutation(256)[:n]
        if name == "slab_install":
            data = torch.from_numpy(rng.integers(-2**31, 2**31, (n, words),
                                                 dtype=np.int32))
            run = functools.partial(slab_install, slab, data.to(device), idx)
            run()
            slab_install(plain, data, idx)
            got, want = slab.cpu(), plain
        else:
            run = functools.partial(slab_gather, slab, idx)
            got, want = run().cpu(), slab_gather(plain, idx)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{name}: max_abs_err {err}")
        nbytes = n * STORE_PAGE  # read once and written once
        src = torch.empty(nbytes, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        emit("slab", op=name, pages=n, page_bytes=STORE_PAGE, max_abs_err=err,
             ms=time_ms(run, TIMING_REPS),
             copy_ms=time_ms(lambda: dst.copy_(src), TIMING_REPS),
             bound_ms=2 * nbytes / PEAK_BYTES_PER_S * 1e3, bound_by="bytes")
        del src, dst


def _time_paged_kernels(device, emit, obj_pages: int) -> dict:
    """The page-addressed kernels at the store's shapes: from_packedbit_paged
    as an object read ([64, 16384] words, cs = STRIPE_UNIT) and as shard
    rows ([88, 16384]), to_packedbit_paged as an admit ([11, 524288] bytes
    into 88 pages).  Each is held against its plain version byte for byte
    on one object's pages scattered over two sub-slabs of random words in
    random order, then timed (CUDA-event medians, L2 flushed) on pages laid
    out as the store lays out a resident that crosses into a second
    sub-slab, in turns with the composition it replaced on the same pages
    (slab_gather and K6, the object's de-interleave then being the host's;
    K5, the zero-filled page image, the copy into it and slab_install),
    beside the kernel on the scattered pages, its plain version, a copy of
    the same bytes and the bound; then the host ms of building one
    resident's page table.  Returns the report rows (the object read stands for the paged
    K6).  The launches are not counted."""
    import torch

    from ceph_tpu_torch.ops import cuda_packedbit as pb
    from ceph_tpu_torch.ops.slab import (PageTable, gather_words,
                                         install_pages, new_subslab)

    words = STORE_PAGE // 4
    rng = np.random.default_rng(SEED + 6)
    slabs = {}
    for s in range(2):
        slabs[s] = new_subslab(256, words, torch.device(device))
        slabs[s].copy_(torch.from_numpy(rng.integers(
            -2 ** 31, 2 ** 31, (256, words), dtype=np.int64).astype(np.int32)))
    scattered = PageTable(rng.permutation(512)[:obj_pages], slabs, words, 8)
    tidy = PageTable(range(256 - obj_pages // 2, 256 + obj_pages - obj_pages // 2),
                     slabs, words, 8)
    L = OBJECT_SIZE // 8
    W = L // 32
    data = torch.from_numpy(rng.integers(0, 256, (11, L), dtype=np.uint8)
                            ).to(device)
    rows = {}

    def report(name, label, kernel, plain, composition, n_bytes, n_pages,
               result):
        """kernel(table) / plain(table) compute the function on a table's
        pages; result(table, out) is what to compare.  n_bytes is the bytes
        read and written, n_pages the page addresses read: the bound counts
        both, the copy the bytes."""
        twin = PageTable(scattered.pages, {s: t.clone() for s, t in
                                           slabs.items()}, words, 8)
        got = result(scattered, kernel(scattered))
        want = result(twin, plain(twin))
        sync(device)
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{name} {label}: {tuple(got.shape)} against {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        check(err == 0, f"{name} {label}: max_abs_err {err}")
        del twin, got, want
        turns = {"kernel": [], "composition": []}
        for arm in ("kernel", "composition", "composition", "kernel"):
            turns[arm].append(time_ms(
                lambda: (kernel if arm == "kernel" else composition)(tidy),
                TIMING_REPS))
        src = torch.empty(n_bytes // 2, dtype=torch.uint8, device=device)
        dst = torch.empty_like(src)
        b_ms, b_by = xor_bound(n_bytes + 8 * n_pages, 0)
        line = {"kernel": name, "path": "cuda", "shape": label,
                "max_abs_err": err, "ms": statistics.mean(turns["kernel"]),
                "ms_turns": turns["kernel"],
                "scattered_ms": time_ms(lambda: kernel(scattered),
                                        TIMING_REPS),
                "composition_ms": statistics.mean(turns["composition"]),
                "composition_ms_turns": turns["composition"],
                "copy_ms": time_ms(lambda: dst.copy_(src), TIMING_REPS),
                "plain_ms": time_ms(lambda: plain(tidy), PLAIN_REPS),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        del src, dst
        emit("paged kernel", **line)
        return line

    def out(table, got):
        return got

    # the object read: 8 data rows' 64 plane rows -> the 4 MiB object
    obj = (0, W, 8, L, STRIPE_UNIT, OBJECT_SIZE)
    rows["from_packedbit_paged"] = report(
        "from_packedbit_paged", f"[64,{W}] object cs={STRIPE_UNIT}",
        lambda t: pb.from_packedbit_paged(t, *obj),
        lambda t: pb.from_packedbit_paged_plain(t, *obj),
        lambda t: pb.from_packedbit(gather_words(t, 0, 64 * W)
                                    .view(64, W), 8),
        64 * W * 4 + OBJECT_SIZE, -(-64 * W // words), out)
    # shard rows: all 11 rows of the object
    report("from_packedbit_paged", f"[88,{W}] rows",
           lambda t: pb.from_packedbit_paged(t, 0, W, 11, L),
           lambda t: pb.from_packedbit_paged_plain(t, 0, W, 11, L),
           lambda t: pb.from_packedbit(gather_words(t, 0, 88 * W)
                                       .view(88, W), 11),
           88 * W * 4 + 11 * L, obj_pages, out)

    # the admit: 11 shard rows into the object's 88 pages
    def image_admit(t):
        planes = pb.to_packedbit(data)
        image = torch.zeros(obj_pages * words, dtype=torch.int32,
                            device=device)
        image[:planes.numel()].view(planes.shape).copy_(planes)
        install_pages(t, image.view(obj_pages, words))

    rows["to_packedbit_paged"] = report(
        "to_packedbit_paged", f"[11,{L}] into {obj_pages} pages",
        lambda t: pb.to_packedbit_paged(data, t),
        lambda t: pb.to_packedbit_paged_plain(data, t), image_admit,
        11 * L + obj_pages * words * 4, obj_pages,
        lambda t, _: torch.stack([t.slabs[0], t.slabs[1]]))
    # what an install now adds: building a resident's page table (its
    # pages' addresses, copied to the card), host ms, medians
    build_ms = []
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        PageTable(tidy.pages, slabs, words, 8)
        sync(device)
        build_ms.append((time.perf_counter() - t0) * 1e3)
    emit("page table", pages=obj_pages, build_ms=statistics.median(build_ms))
    del scattered, tidy, slabs, data
    return rows


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


# -------------------------------------------------------------- phase osd --

OSD_COUNT = 12       # 11 hold a k=8 m=3 object's shards, one is left to recover on
OSD_IN_FLIGHT = 8    # client ops in flight
OSD_PG_NUM = 16


def _pcts(samples_ms):
    """p50 and p99 of a list of milliseconds."""
    a = np.asarray(samples_ms, dtype=np.float64)
    return {"p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def _summed(perf_sets):
    """The plain counters of several daemons' sets of one name, summed."""
    out = collections.Counter()
    for perf in perf_sets:
        for name, value in perf.dump().items():
            if isinstance(value, (int, float)):
                out[name] += value
    return dict(out)


def _op_step_gaps(osds, kind: str, seen: set):
    """p50/p99 µs of each step of the OSDs' client ops of one kind ("write"
    or "read") that finished since the last call (`seen` holds the ops
    already counted): the gap between each adjacent pair of events of an
    op's timeline (a primary's write: queued_for_pg, reached_pg,
    ec_encode_dispatched, encoded, sub_writes_sent, waiting_for_subops,
    commit_gathered, commit_sent, done), over every OSD's historic ops."""
    gaps = collections.defaultdict(list)
    for osd in osds:
        for op in osd.ctx.op_tracker.dump_historic_ops()["ops"]:
            if not op["description"].startswith(f"osd_op({kind} ") \
                    or (id(osd), op["seq"]) in seen:
                continue
            seen.add((id(osd), op["seq"]))
            prev, t_prev = "initiated", op["initiated_at"]
            for e in op["type_data"]["events"]:
                gaps[f"{prev}->{e['event']}"].append(
                    (e["time"] - t_prev) * 1e6)
                prev, t_prev = e["event"], e["time"]
    return {name: {"p50_us": float(np.percentile(v, 50)),
                   "p99_us": float(np.percentile(v, 99)), "count": len(v)}
            for name, v in gaps.items()}


OSD_POOL = {"plugin": "cuda", "technique": "reed_sol_van", "k": "8", "m": "3"}


def phase_osd(device, card, n_objects=QUEUE_OBJECTS, store_bytes=STORE_BYTES,
              pool_profile=OSD_POOL, label="osd"):
    """The OSD daemon path: an in-process vstart cluster of one mon and
    OSD_COUNT OSDs on MemStore, at the default EC device conf (batching on,
    residency on, the paged store's device arm at 256 MiB of 64 KiB pages,
    the 2 ms window), one k=8 m=3 pool of `pool_profile` (plugin=cuda
    reed_sol_van by default), 4 MiB objects.  Writes, reads, degraded reads
    after one OSD is lost, and a repair followed by a second loss; every
    read byte for byte, every stored shard and HashInfo against the CPU
    codec of the same profile (plugin=jerasure in plugin=cuda's place).
    Recovery is left to repair_pool (osd_auto_repair off) so that its time
    is its own.  The queue and the store are one per process, shared by the
    OSDs, as in any in-process cluster.  Returns each kernel's launch count
    in this run.  `store_bytes` is the resident store's budget
    (osd_ec_planar_bytes; the default is the OSD's own, 256 MiB); each line
    printed starts with `label`."""
    import asyncio

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF
    from ceph_tpu_torch.ops.gf2 import SCHED_PERF
    from ceph_tpu_torch.rados import ecutil
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados.vstart import Cluster

    def emit(step, **numbers):
        print(f"{label} " + json.dumps({"step": step, **numbers,
                                        "store_bytes": store_bytes,
                                        "card": card}))

    cpu_plugin = ("jerasure" if pool_profile["plugin"] == "cuda"
                  else pool_profile["plugin"])
    cpu = _codec(cpu_plugin, "cpu", **{k: v for k, v in pool_profile.items()
                                       if k != "plugin"})
    rng = np.random.default_rng(SEED + 10)
    objects = {f"{label}-{i}": rng.integers(0, 256, OBJECT_SIZE,
                                            dtype=np.uint8).tobytes()
               for i in range(n_objects)}
    total = OBJECT_SIZE * n_objects
    conf = {"osd_ec_device": str(device), "osd_auto_repair": False,
            "client_op_timeout": 60.0, "osd_op_history_size": 4096,
            "osd_ec_planar_bytes": store_bytes}

    async def timed_ops(fn):
        """fn(oid) for every object, OSD_IN_FLIGHT at a time; returns the
        results in order, the wall seconds and each op's ms."""
        gate = asyncio.Semaphore(OSD_IN_FLIGHT)
        lat = []

        async def one(oid):
            async with gate:
                t = time.perf_counter()
                out = await fn(oid)
                lat.append((time.perf_counter() - t) * 1e3)
                return out

        t0 = time.perf_counter()
        out = await asyncio.gather(*(one(oid) for oid in objects))
        return out, time.perf_counter() - t0, lat

    def live_shards(cluster, pool):
        held = collections.defaultdict(set)
        for osd in cluster.osds.values():
            for oid, shard in osd.store.list_objects(pool):
                if shard < osdmod.PREV_SLOT:
                    held[oid].add(shard)
        return held

    async def read_all(client, pool, step):
        got, wall, lat = await timed_ops(lambda oid: client.get(pool, oid))
        for oid, data in zip(objects, got):
            check(data == objects[oid], f"{label} {step}: {oid} read back wrong")
        return wall, lat

    def osd_sum(cluster, name):
        return sum(o.perf.get(name) for o in cluster.osds.values())

    async def run():
        cluster = Cluster(n_osds=OSD_COUNT, conf=dict(conf))
        await cluster.start()
        client = await cluster.client()
        try:
            queue, store = osdmod._BATCH_QUEUE, osdmod._PLANAR_STORE
            check(queue is not None and queue.device.type == "cuda",
                  f"{label}: the OSDs' queue is not on the card: {queue}")
            check(store is not None and store.device.type == "cuda"
                  and store.device_arm, f"{label}: the OSDs' resident store "
                  "is not on the card's device arm")
            pool = await client.create_pool(
                label, "ec", pg_num=OSD_PG_NUM, profile=dict(pool_profile))
            # a. writes
            _, wall, lat = await timed_ops(
                lambda oid: client.put(pool, oid, objects[oid]))
            emit("writes", objects=n_objects, in_flight=OSD_IN_FLIGHT,
                 objects_per_s=n_objects / wall, GB_per_s=total / wall / 1e9,
                 wall_s=wall, **_pcts(lat))
            osds = list(cluster.osds.values())
            seen = set()
            emit("write steps", **_op_step_gaps(osds, "write", seen))
            # the device's busy share over puts: a quarter of the objects
            # put again, same bytes, under the profiler
            again = list(objects)[:n_objects // 4]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                await asyncio.gather(*(client.put(pool, oid, objects[oid])
                                       for oid in again))
                sync(device)
                wall_ms = (time.perf_counter() - t0) * 1e3
            on_card = sum(e.self_device_time_total / 1e3
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            emit("writes profiled", objects=len(again), wall_ms=wall_ms,
                 device_ms=on_card, device_busy_share=on_card / wall_ms)
            sinfo = osds[0]._sinfo(client.osdmap.pools[pool])
            for oid, data in objects.items():
                want = ecutil.batched_encode(cpu, sinfo, data)
                hinfo = ecutil.HashInfo(11)
                hinfo.append({c: bytes(want[c]) for c in range(11)})
                seen = set()
                for osd in osds:
                    for c in range(11):
                        got = osd.store.read((pool, oid, c))
                        if got is None:
                            continue
                        seen.add(c)
                        check(bytes(got[0]) == bytes(want[c]),
                              f"{label} {oid} shard {c} on osd.{osd.osd_id} "
                              f"differs from the CPU plugin={cpu_plugin}")
                        check(osd.store.getattr((pool, oid, c), "hinfo_key")
                              == hinfo.encode(),
                              f"{label} {oid} shard {c}: HashInfo differs")
                check(seen == set(range(11)), f"{label} {oid} stored {seen}")
            emit("shards", objects=n_objects, shards_checked=11 * n_objects,
                 shard_bytes=len(want[0]), sinfo_stripe_width=sinfo.stripe_width)
            # b. reads
            hits0 = osd_sum(cluster, "planar_read_hits")
            subr0 = osd_sum(cluster, "subop_r")
            wall, lat = await read_all(client, pool, "reads")
            emit("reads", objects=n_objects, GB_per_s=total / wall / 1e9,
                 wall_s=wall, from_residents=osd_sum(
                     cluster, "planar_read_hits") - hits0,
                 shard_subreads=osd_sum(cluster, "subop_r") - subr0,
                 resident_entries=store.stats()["entries"], **_pcts(lat))
            emit("read steps", **_op_step_gaps(osds, "read", seen))
            # c. degraded reads: lose the OSD in the most PGs' acting sets
            p = client.osdmap.pools[pool]
            member = collections.Counter(
                a for pg in range(p.pg_num)
                for a in client.osdmap.pg_to_acting(p, pg)
                if a != CRUSH_ITEM_NONE)
            victim = min(member, key=lambda o: (-member[o], o))
            await cluster.kill_osd(victim)
            await client.mark_osd_down(victim)
            await client.refresh_map()
            wall, lat = await read_all(client, pool, "degraded reads")
            emit("degraded reads", lost_osd=victim,
                 acting_sets_of_lost=member[victim], pgs=p.pg_num,
                 GB_per_s=total / wall / 1e9, wall_s=wall, **_pcts(lat))
            emit("degraded read steps", **_op_step_gaps(osds, "read", seen))
            # d. recovery, then a second loss
            push0 = osd_sum(cluster, "recovery_push")
            moved0 = osd_sum(cluster, "backfill_bytes_moved")
            t0 = time.perf_counter()
            await client.repair_pool(pool)
            repair_s = time.perf_counter() - t0
            for _ in range(600):
                held = live_shards(cluster, pool)
                if all(len(held[oid]) == 11 for oid in objects):
                    break
                await asyncio.sleep(0.05)
            else:
                check(False, f"{label}: recovery left objects short of 11 shards")
            recovery_s = time.perf_counter() - t0
            emit("recovery", repair_pool_s=repair_s, restored_s=recovery_s,
                 shards_pushed=osd_sum(cluster, "recovery_push") - push0,
                 bytes_pushed=osd_sum(cluster, "backfill_bytes_moved")
                 - moved0)
            second = min(o for o in cluster.osds if o != victim)
            await cluster.kill_osd(second)
            await client.mark_osd_down(second)
            await client.refresh_map()
            wall, lat = await read_all(client, pool, "reads after recovery")
            emit("reads after recovery", lost_osds=[victim, second],
                 GB_per_s=total / wall / 1e9, wall_s=wall, **_pcts(lat))
            # e. counters and op phases
            merged = collections.defaultdict(list)
            for osd in cluster.osds.values():
                for phase, v in osd.ctx.op_tracker.phase_samples().items():
                    merged[phase].extend(v)
            emit("op phases", **{ph: _pcts([x * 1e3 for x in v])
                                 for ph, v in merged.items() if v})
            counters = {"ec_cuda": queue.perf.dump(),
                        "ec_plugin": PLUGIN_PERF.dump(),
                        "gf2_sched": SCHED_PERF.dump(),
                        "pagestore": store.perf.dump(),
                        # per-daemon sets, summed over all 12 OSDs
                        "osd": _summed(o.perf for o in osds),
                        "tier": _summed(o.tier_perf for o in osds)}
            emit("counters", **counters)
            return queue, store
        finally:
            await client.stop()
            await cluster.stop()

    _zero_counts()
    t_phase = time.perf_counter()
    try:
        queue, store = asyncio.run(asyncio.wait_for(run(), 600))
        counts, _ = _read_counts(device, f"({label})")
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()
        osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
    check(PLUGIN_PERF.get("cpu_fallback") == 0
          and PLUGIN_PERF.get("device_failed") == 0,
          f"{label}: the cuda plugin fell back or failed on the card")
    check(queue.perf.get("breaker_fallback") == 0,
          f"{label}: the queue's breaker served a group off the card")
    check(store.device_installs > 0, f"{label}: no device-native install")
    for name in ("apply_packedbit", "from_packedbit_paged"):
        check(counts[name] > 0, f"{label}: {name} never launched")
    print(f"{label}: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


# ----------------------------------------------------------- phase codecs --

# BASELINE.md's five configurations, as the benchmark CLI takes them
BASELINE_CONFIGS = (
    ("jerasure reed_sol_van k=4 m=2",
     ["--plugin", "jerasure", "-P", "technique=reed_sol_van", "-P", "k=4",
      "-P", "m=2"]),
    ("isa reed_sol_van k=8 m=3",
     ["--plugin", "isa", "-P", "technique=reed_sol_van", "-P", "k=8",
      "-P", "m=3"]),
    ("jerasure cauchy_good k=10 m=4",
     ["--plugin", "jerasure", "-P", "technique=cauchy_good", "-P", "k=10",
      "-P", "m=4"]),
    ("lrc k=4 m=2 l=3", ["--plugin", "lrc", "-P", "k=4", "-P", "m=2",
                         "-P", "l=3"]),
    ("clay k=8 m=4 d=11", ["--plugin", "clay", "-P", "k=8", "-P", "m=4",
                           "-P", "d=11"]),
)
CODEC_ITERATIONS = 10        # per CLI run of the codecs phase
CLAY_ITERATIONS = 2          # clay on the card: hundreds of launches an object
OSD_ISA_OBJECTS = 16
# lrc k=4 m=2 l=3 in its explicit form, each layer a codec of `plugin`
LRC_CHUNKS = ("DDc_DDc_", "DDDc____", "____DDDc")


def _lrc_layers(plugin: str) -> str:
    return json.dumps([[c, f"plugin={plugin} technique=reed_sol_van"]
                       for c in LRC_CHUNKS])


def _cpu_model() -> str:
    """The host CPU as lscpu gives it: model name, vendor, family and
    model number (a virtual machine may report its name as "unknown")."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True,
                         timeout=60)
    fields = dict(line.split(":", 1) for line in out.stdout.splitlines()
                  if ":" in line)
    return ", ".join(f"{key} {fields[key].strip()}" for key in
                     ("Model name", "Vendor ID", "CPU family", "Model")
                     if key in fields)


def _cli_gbps(argv, label, emit, **extra) -> None:
    """One benchmark CLI run, its rate emitted as a line."""
    seconds, kb, gbps, _ = _bench(argv)
    emit("cli", config=label, argv=" ".join(argv), seconds=seconds, KB=kb,
         GB_per_s=gbps, **extra)


def phase_codecs(device, card):
    """The CPU codec plugins and the native core, then lrc and clay on
    plugin=cuda, then an isa pool through the daemon.  Returns each
    kernel's launch counts by run ("codecs", "osd-isa")."""
    from ceph_tpu_torch.ec.gf import gf
    from ceph_tpu_torch.ec.registry import registry
    from ceph_tpu_torch.native import bridge
    from ceph_tpu_torch.ops import cuda_packedbit

    cpu_model, threads = _cpu_model(), os.cpu_count()
    t_phase = time.perf_counter()

    def emit(step, **numbers):
        print("codecs " + json.dumps({"step": step, **numbers,
                                      "card": card}))

    # a. the CPU baselines on this machine's CPU, chunks held against the
    #    numpy oracle first
    bridge.lib()
    rng = np.random.default_rng(SEED + 20)
    for plugin, k, m in (("isa", 8, 3), ("jerasure", 8, 3), ("jerasure", 4, 2)):
        codec = registry.factory(plugin, "", {
            "plugin": plugin, "technique": "reed_sol_van",
            "k": str(k), "m": str(m)})
        rows = rng.integers(0, 256, (k, OBJECT_SIZE // k), dtype=np.uint8)
        check(np.array_equal(codec.encode_chunks(rows),
                             gf(8).matmul(codec.matrix, rows)),
              f"{plugin} k={k} m={m}: the native core differs from the "
              "numpy oracle")
    emit("native identity", simd=bridge.simd_kind(), cpu=cpu_model,
         threads=threads, checked="isa k=8 m=3, jerasure k=8 m=3 and k=4 "
         f"m=2 parity of a {OBJECT_SIZE} byte object = numpy GF(2^8) oracle")
    size = ["--size", str(OBJECT_SIZE), "--iterations", str(CODEC_ITERATIONS)]
    for label, argv in BASELINE_CONFIGS:
        for workload in (["--workload", "encode"],
                         ["--workload", "decode", "--erasures", "2"]):
            _cli_gbps(argv + size + workload, label, emit, device="cpu",
                      simd=bridge.simd_kind(), cpu=cpu_model, threads=threads)

    # b. lrc and clay on plugin=cuda, every chunk and decode against the
    #    jerasure-layered CPU codecs
    obj = np.random.default_rng(SEED + 21).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    cases = (
        ("lrc k=4 m=2 l=3 (plugin=cuda layers)",
         {"plugin": "lrc", "mapping": "DD__DD__", "layers": _lrc_layers("cuda")},
         {"plugin": "lrc", "mapping": "DD__DD__",
          "layers": _lrc_layers("jerasure")},
         (2, 5), CODEC_ITERATIONS),
        ("clay k=8 m=4 d=11 scalar_mds=cuda",
         {"plugin": "clay", "k": "8", "m": "4", "d": "11", "scalar_mds": "cuda"},
         {"plugin": "clay", "k": "8", "m": "4", "d": "11"},
         (0, 11), CLAY_ITERATIONS),
    )
    k4 = cuda_packedbit.apply_packedbit
    _zero_counts()
    for label, profile, twin_profile, lost, iterations in cases:
        codec = registry.factory(profile["plugin"], "", dict(profile),
                                 device=device)
        twin = registry.factory(twin_profile["plugin"], "", dict(twin_profile))
        n = codec.get_chunk_count()
        sync(device)
        before = k4.launches
        got = codec.encode(set(range(n)), obj)
        sync(device)
        per_encode = k4.launches - before
        want = twin.encode(set(range(n)), obj)
        for c in range(n):
            check(np.array_equal(got[c], want[c]),
                  f"{label} chunk {c} differs from the CPU jerasure twin")
        avail = {c: want[c] for c in range(n) if c not in lost}
        before = k4.launches
        out = codec.decode(set(lost), avail, len(want[0]))
        sync(device)
        per_decode = k4.launches - before
        for c in lost:
            check(np.array_equal(out[c], want[c]),
                  f"{label} chunk {c} decoded wrong")
        if profile["plugin"] == "clay":
            plan = codec.minimum_to_decode({1}, set(range(n)) - {1})
            sc = len(want[0]) // codec.get_sub_chunk_count()
            helpers = {c: np.concatenate([want[c][o * sc:(o + r) * sc]
                                          for o, r in runs])
                       for c, runs in plan.items()}
            before = k4.launches
            out = codec.decode({1}, helpers, len(want[0]))
            sync(device)
            per_repair = k4.launches - before
            check(np.array_equal(out[1], want[1]),
                  f"{label}: the sub-chunk repair of chunk 1 is wrong")
        else:
            per_repair = None
        check(per_encode > 0 and per_decode > 0,
              f"{label}: apply_packedbit did not launch")
        emit("identity", config=label, chunks=n, chunk_bytes=len(want[0]),
             lost=list(lost), k4_launches_per_encode=per_encode,
             k4_launches_per_decode=per_decode,
             k4_launches_per_repair=per_repair)
        argv = ["--plugin", profile["plugin"], "--device", str(device)] + [
            a for key, v in profile.items() if key != "plugin"
            for a in ("-P", f"{key}={v}")]
        run = ["--size", str(OBJECT_SIZE), "--iterations", str(iterations)]
        for workload in (["--workload", "encode"],
                         ["--workload", "decode", "--erasures", "2"]):
            _cli_gbps(argv + run + workload, label, emit, device=str(device))
    counts, _ = _read_counts(device, "(codecs)")
    check(counts["apply_packedbit"] > 0, "codecs: apply_packedbit never launched")

    # c. an isa pool through the daemon on the card
    isa_counts = phase_osd(device, card, n_objects=OSD_ISA_OBJECTS,
                           pool_profile={"plugin": "isa",
                                         "technique": "reed_sol_van",
                                         "k": "8", "m": "3"}, label="osd-isa")
    print(f"codecs: phase {time.perf_counter() - t_phase:.2f}s wall")
    return {name: {"codecs": counts[name], "osd-isa": isa_counts[name]}
            for name in counts}


# ---------------------------------------------------------- phase clients --

CLIENT_IMAGE_OBJECTS = 16    # a 64 MiB image of 4 MiB objects
CLIENT_ORDER = 22            # rbd's default: objects of 2^22 bytes
CLIENT_RMW_WRITES = 16
CLIENT_RMW_BYTES = 64 << 10
CLIENT_SNAP_WRITES = 4
CLIENT_STRIPER_BYTES = 24 << 20


async def _scrape(addr, path="/metrics") -> str:
    """GET `path` from the mgr's HTTP frontend; the body."""
    import asyncio

    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"GET {path} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read(-1)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    check(b" 200 " in head.split(b"\r\n")[0], f"mgr {path}: {head[:80]!r}")
    return body.decode()


def phase_clients(device, card):
    """The client APIs and the mgr on the OSD daemon path: a vstart cluster
    of one mon, OSD_COUNT OSDs (MemStore, the default EC device conf) and
    the mgr, one plugin=cuda reed_sol_van k=8 m=3 pool of OSD_PG_NUM PGs
    reached through librados; an RBD image of CLIENT_IMAGE_OBJECTS objects
    of 2^CLIENT_ORDER bytes written, read, partly overwritten (RMW), snapshotted,
    exported and imported into a second image, and read degraded after an
    OSD is lost; a RadosStriper round trip; then the mgr's /metrics.  Every
    read is held against a model of the image.  Returns each kernel's launch
    count in this run."""
    import asyncio

    import torch

    from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.rados.striper import RadosStriper
    from ceph_tpu_torch.rados.vstart import Cluster
    from ceph_tpu_torch.services import rbd_export
    from ceph_tpu_torch.services.rbd import RBD

    def emit(step, **numbers):
        print("clients " + json.dumps({"step": step, **numbers,
                                       "card": card}))

    obj_bytes = 1 << CLIENT_ORDER
    size = CLIENT_IMAGE_OBJECTS * obj_bytes
    rng = np.random.default_rng(SEED + 12)
    model = bytearray(rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    conf = {"osd_ec_device": str(device), "osd_auto_repair": False,
            "client_op_timeout": 60.0, "osd_heartbeat_interval": 0.2}
    kind = torch.device(device).type

    def patch_at(obj):
        """A seeded offset inside object `obj` and CLIENT_RMW_BYTES of
        data."""
        off = obj * obj_bytes + int(rng.integers(0, obj_bytes
                                                 - CLIENT_RMW_BYTES))
        return off, rng.integers(0, 256, CLIENT_RMW_BYTES,
                                 dtype=np.uint8).tobytes()

    def osd_sum(cluster, name):
        return sum(o.perf.get(name) for o in cluster.osds.values())

    async def run():
        cluster = Cluster(n_osds=OSD_COUNT, conf=dict(conf), with_mgr=True)
        await cluster.start()
        rados = await Rados(cluster.mon_addrs, dict(conf)).connect()
        try:
            queue, store = osdmod._BATCH_QUEUE, osdmod._PLANAR_STORE
            check(queue is not None and queue.device.type == kind,
                  f"clients: the OSDs' queue is not on {kind}: {queue}")
            check(store is not None and store.device.type == kind
                  and store.device_arm, "clients: the OSDs' resident store "
                  f"is not on {kind}'s device arm")
            await rados.pool_create("rbd", pg_num=OSD_PG_NUM,
                                    profile=dict(OSD_POOL))
            ioctx = await rados.open_ioctx("rbd")
            rbd = RBD(ioctx)
            img = await rbd.create("disk", size, order=CLIENT_ORDER)

            async def read_image(image, snap=None):
                t = time.perf_counter()
                got = (await image.read_snap(snap, 0, size) if snap
                       else await image.read(0, size))
                wall = time.perf_counter() - t
                return got, wall

            # a. one sequential write of the whole image
            t = time.perf_counter()
            await img.write(0, bytes(model))
            wall = time.perf_counter() - t
            emit("image write", objects=CLIENT_IMAGE_OBJECTS,
                 object_bytes=obj_bytes,
                 GB_per_s=size / wall / 1e9, wall_s=wall)
            # b. the whole image read back
            got, wall = await read_image(img)
            check(got == model, "clients: image read differs from the model")
            emit("image read", GB_per_s=size / wall / 1e9, wall_s=wall)
            # c. partial writes inside objects: the OSD's read-modify-write
            rmw0 = osd_sum(cluster, "rmw_partial")
            lat = []
            for obj in rng.integers(0, CLIENT_IMAGE_OBJECTS,
                                    CLIENT_RMW_WRITES):
                off, data = patch_at(int(obj))
                t = time.perf_counter()
                await img.write(off, data)
                lat.append((time.perf_counter() - t) * 1e3)
                model[off:off + len(data)] = data
            rmw = osd_sum(cluster, "rmw_partial") - rmw0
            check(rmw == CLIENT_RMW_WRITES,
                  f"clients: {rmw} RMW partial writes counted, "
                  f"{CLIENT_RMW_WRITES} made")
            got, _ = await read_image(img)
            check(got == model, "clients: image differs after the RMW writes")
            emit("rmw writes", writes=CLIENT_RMW_WRITES,
                 bytes=CLIENT_RMW_BYTES,
                 rmw_partial=rmw, **_pcts(lat))
            # d. a snapshot, writes after it, and the snapshot read
            snap_model = bytes(model)
            await img.snap_create("s1")
            for obj in rng.choice(CLIENT_IMAGE_OBJECTS, CLIENT_SNAP_WRITES,
                                  replace=False):
                off, data = patch_at(int(obj))
                await img.write(off, data)
                model[off:off + len(data)] = data
            got, wall = await read_image(img, snap="s1")
            check(got == snap_model, "clients: snapshot read differs")
            emit("snapshot read", writes_after_snap=CLIENT_SNAP_WRITES,
                 GB_per_s=size / wall / 1e9, wall_s=wall)
            got, _ = await read_image(img)
            check(got == model, "clients: head differs after the snapshot")
            # e. export the snapshot and the diff from it, import both
            full, delta = io.BytesIO(), io.BytesIO()
            t = time.perf_counter()
            await rbd_export.export_image(img, full, snap="s1")
            await rbd_export.export_diff(img, delta, from_snap="s1")
            export_s = time.perf_counter() - t
            full.seek(0)
            delta.seek(0)
            t = time.perf_counter()
            img2 = await rbd_export.import_image(rbd, "disk2", full,
                                                 order=CLIENT_ORDER)
            await rbd_export.apply_diff(img2, delta)
            import_s = time.perf_counter() - t
            streamed = len(full.getvalue()) + len(delta.getvalue())
            got, _ = await read_image(img2)
            check(got == model, "clients: the imported image differs")
            emit("export import", stream_bytes=streamed,
                 export_MB_per_s=streamed / export_s / 1e6,
                 import_MB_per_s=streamed / import_s / 1e6,
                 export_s=export_s, import_s=import_s)
            # f. the striper
            striper = RadosStriper(ioctx, object_size=obj_bytes)
            blob = rng.integers(0, 256, CLIENT_STRIPER_BYTES,
                                dtype=np.uint8).tobytes()
            t = time.perf_counter()
            await striper.write("striped", blob)
            w_s = time.perf_counter() - t
            t = time.perf_counter()
            back = await striper.read("striped")
            r_s = time.perf_counter() - t
            check(back == blob, "clients: striped object read back wrong")
            emit("striper", bytes=CLIENT_STRIPER_BYTES,
                 write_GB_per_s=CLIENT_STRIPER_BYTES / w_s / 1e9,
                 read_GB_per_s=CLIENT_STRIPER_BYTES / r_s / 1e9)
            # g. lose the OSD in the most acting sets, read degraded
            client = rados._client
            p = client.osdmap.pools[ioctx.pool_id]
            member = collections.Counter(
                a for pg in range(p.pg_num)
                for a in client.osdmap.pg_to_acting(p, pg)
                if a != CRUSH_ITEM_NONE)
            victim = min(member, key=lambda o: (-member[o], o))
            await cluster.kill_osd(victim)
            await client.mark_osd_down(victim)
            await client.refresh_map()
            got, wall = await read_image(img)
            check(got == model, "clients: degraded image read differs")
            emit("degraded read", lost_osd=victim,
                 GB_per_s=size / wall / 1e9, wall_s=wall)
            # h. the mgr: every live daemon reports again, then /metrics
            mgr, t_last = cluster.mgr, time.time()
            live = [f"osd.{i}" for i in sorted(cluster.osds)]
            for _ in range(200):
                if all(n in mgr.reports and mgr.reports[n].stamp > t_last
                       for n in live):
                    break
                await asyncio.sleep(0.05)
            else:
                check(False, "clients: live OSDs did not report to the mgr")
            text = await _scrape(mgr.http_addr)
            dispatch = queue.perf.get("dispatch")
            series = {ln.rsplit(" ", 1)[0]: ln.rsplit(" ", 1)[1]
                      for ln in text.splitlines()
                      if ln and not ln.startswith("#")}
            check(dispatch > 0, "clients: the queue dispatched nothing")
            for name in live:
                got = series.get(f'ceph_ec_cuda_dispatch{{daemon="{name}"}}')
                check(got is not None and float(got) == dispatch,
                      f"clients: /metrics has ceph_ec_cuda_dispatch {got} "
                      f"for {name}, the queue {dispatch}")
            check("ceph_health_status" in series,
                  "clients: /metrics has no ceph_health_status")
            emit("mgr scrape", series=len(series), live_osds=len(live),
                 ec_cuda_dispatch=dispatch,
                 health_status=series["ceph_health_status"],
                 reports=len(mgr.reports))
            emit("counters", ec_cuda=queue.perf.dump(),
                 ec_plugin=PLUGIN_PERF.dump(), pagestore=store.perf.dump())
            return queue, store
        finally:
            await rados.shutdown()
            await cluster.stop()

    t_phase = time.perf_counter()
    _zero_counts()
    try:
        queue, store = asyncio.run(asyncio.wait_for(run(), 300))
        counts, _ = _read_counts(device, "(clients)")
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()
        osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
    check(PLUGIN_PERF.get("cpu_fallback") == 0
          and PLUGIN_PERF.get("device_failed") == 0,
          "clients: the cuda plugin fell back or failed on the card")
    check(queue.perf.get("breaker_fallback") == 0,
          "clients: the queue's breaker served a group off the card")
    for name in ("apply_packedbit", "from_packedbit_paged"):
        check(counts[name] > 0, f"clients: {name} never launched")
    emit("launches", k4_apply_packedbit=counts["apply_packedbit"],
         k6_from_packedbit_paged=counts["from_packedbit_paged"])
    print(f"clients: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


# --------------------------------------------------------- phase services --

SERVICE_STRIPE = 4 << 20     # rgw_obj_stripe_size and CephFS's object size
SERVICE_PUTS = 16            # S3 objects of one stripe
SERVICE_PARTS = 4            # multipart parts ...
SERVICE_PART_BYTES = 8 << 20  # ... of 8 MiB (S3's smallest part is 5 MiB)
SERVICE_RANGE_BYTES = 1 << 20
SERVICE_FILES = 8            # CephFS files ...
SERVICE_FILE_BYTES = 8 << 20  # ... of two objects each


async def _http(addr, method, target, body=b"", headers=None):
    """One HTTP/1.1 exchange with an RGW frontend: (status, headers,
    payload)."""
    import asyncio

    hdrs = {"content-length": str(len(body)), **(headers or {})}
    reader, writer = await asyncio.open_connection(*addr)
    writer.write(f"{method} {target} HTTP/1.1\r\n".encode()
                 + "".join(f"{k}: {v}\r\n" for k, v in hdrs.items()).encode()
                 + b"\r\n" + body)
    await writer.drain()
    status = (await reader.readline()).decode()
    got = {}
    while True:
        line = await reader.readline()
        if line in (b"\r\n", b"\n", b""):
            break
        k, _, v = line.decode().partition(":")
        got[k.strip().lower()] = v.strip()
    n = int(got.get("content-length", 0))
    payload = await reader.readexactly(n) if n else b""
    writer.close()
    return status.split(" ", 1)[1].strip(), got, payload


def phase_services(device, card):
    """The object gateway and CephFS on the OSD daemon path: phase_clients's
    cluster (OSD_COUNT OSDs on MemStore, the mgr, the default EC device
    conf), its plugin=cuda k=8 m=3 pool of OSD_PG_NUM PGs as the data pool
    and a replicated metadata pool.  RGW on the data pool with 4 MiB stripes
    through its HTTP frontend, SigV4 as a user RgwAdmin made: SERVICE_PUTS
    PUTs of a stripe, a multipart upload of SERVICE_PARTS parts of
    SERVICE_PART_BYTES, a LIST, GETs, 1 MiB range GETs and the multipart
    GET.  CephFS over MDSCluster(n_ranks=2) through CephFSMultiClient: two
    directories, one exported to rank 1, SERVICE_FILES files of
    SERVICE_FILE_BYTES written and read, a snapshot, a rename across ranks,
    replace_rank(1).  Then the OSD in the most acting sets is lost and every
    object and file is read again.  Every read is held against a seeded
    model.  Returns each kernel's launch count in this run."""
    import asyncio

    import torch

    from ceph_tpu_torch.ec.plugins.cuda import PLUGIN_PERF
    from ceph_tpu_torch.ops import slab
    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.crush import CRUSH_ITEM_NONE
    from ceph_tpu_torch.rados.librados import Rados
    from ceph_tpu_torch.rados.vstart import Cluster
    from ceph_tpu_torch.services import rgw
    from ceph_tpu_torch.services.mds_cluster import (CephFSMultiClient,
                                                     MDSCluster)

    def emit(step, **numbers):
        print("services " + json.dumps({"step": step, **numbers,
                                        "card": card}))

    rng = np.random.default_rng(SEED + 13)

    def seeded(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    objects = {f"obj{i:02d}": seeded(SERVICE_STRIPE)
               for i in range(SERVICE_PUTS)}
    parts = [seeded(SERVICE_PART_BYTES) for _ in range(SERVICE_PARTS)]
    files = {f"/d{i % 2}/f{i}": seeded(SERVICE_FILE_BYTES)
             for i in range(SERVICE_FILES)}
    conf = {"osd_ec_device": str(device), "osd_auto_repair": False,
            "client_op_timeout": 60.0, "osd_heartbeat_interval": 0.2}
    kind = torch.device(device).type
    slab_calls = {"slab_install": [0], "slab_gather": [0]}

    def gbps(nbytes, wall):
        return {"GB_per_s": nbytes / wall / 1e9, "wall_s": wall}

    async def run():
        cluster = Cluster(n_osds=OSD_COUNT, conf=dict(conf), with_mgr=True)
        await cluster.start()
        rados = await Rados(cluster.mon_addrs, dict(conf)).connect()
        frontend = None
        try:
            queue, store = osdmod._BATCH_QUEUE, osdmod._PLANAR_STORE
            check(queue is not None and queue.device.type == kind,
                  f"services: the OSDs' queue is not on {kind}: {queue}")
            check(store is not None and store.device.type == kind
                  and store.device_arm, "services: the OSDs' resident "
                  f"store is not on {kind}'s device arm")
            await rados.pool_create("data", pg_num=OSD_PG_NUM,
                                    profile=dict(OSD_POOL))
            await rados.pool_create("meta", pool_type="replicated",
                                    profile={"size": "3"})
            data = await rados.open_ioctx("data")
            meta = await rados.open_ioctx("meta")
            index_writes = [0]
            op_spans = collections.defaultdict(lambda: [0, 0.0])

            def op_class(oid):
                if oid.startswith(".bucket.index."):
                    return "index"
                if oid == ".rgw.datalog":
                    return "datalog"
                if oid.startswith(".bucket.meta."):
                    return "bucket_meta"
                if oid.endswith(".__striper__"):
                    return "stripe_header"
                return "stripe_piece" if "/" in oid else "other"

            def timed(method):
                real = getattr(data, method)

                async def call(oid, *a, **kw):
                    if method == "write_full" and op_class(oid) == "index":
                        index_writes[0] += 1
                    t = time.perf_counter()
                    try:
                        return await real(oid, *a, **kw)
                    finally:
                        span = op_spans[f"{method} {op_class(oid)}"]
                        span[0] += 1
                        span[1] += time.perf_counter() - t

                setattr(data, method, call)

            for method in ("read", "write_full", "remove", "execute"):
                timed(method)

            def op_split(n):
                """The data pool's ops since the last call, by method and
                object class: count and ms per request (one request in
                flight, so the spans add up)."""
                out = {name: {"ops": c / n, "ms": sec * 1e3 / n}
                       for name, (c, sec) in sorted(op_spans.items())}
                op_spans.clear()
                return out
            svc = rgw.RgwService(data, chunk_size=SERVICE_STRIPE)
            user = await rgw.RgwAdmin(svc).user_create("smoke", "Smoke")
            ak, sk = user["access_key"], user["secret_key"]
            frontend = rgw.RgwFrontend(svc)
            addr = await frontend.start()
            host = f"{addr[0]}:{addr[1]}"

            async def s3(method, path, body=b"", query="", headers=None,
                         want="200"):
                hdrs = {"host": host, "content-length": str(len(body)),
                        **(headers or {})}
                hdrs.update(rgw.sign_request(ak, sk, method, path, query,
                                             hdrs, body))
                target = path + (f"?{query}" if query else "")
                st, h, payload = await _http(addr, method, target, body,
                                             hdrs)
                check(st.startswith(want),
                      f"services: {method} {target}: {st} {payload[:120]!r}")
                return h, payload

            async def get_all(step, after_plain=lambda wall: None):
                t = time.perf_counter()
                for key, blob in objects.items():
                    _, got = await s3("GET", f"/bkt/{key}")
                    check(got == blob, f"services {step}: {key} differs")
                wall = time.perf_counter() - t
                after_plain(wall)
                t = time.perf_counter()
                _, got = await s3("GET", "/bkt/multi")
                mwall = time.perf_counter() - t
                check(got == b"".join(parts),
                      f"services {step}: the multipart object differs")
                return wall, mwall

            def route_read(mc, path):
                return mc.route(path)[1].fs.read_file(path)

            async def read_files(mc, step):
                t = time.perf_counter()
                for path, blob in files.items():
                    got = await route_read(mc, path)
                    check(got == blob, f"services {step}: {path} differs")
                return time.perf_counter() - t

            # a. S3: a bucket and SERVICE_PUTS PUTs of a stripe
            await s3("PUT", "/bkt")
            op_split(1)
            index0 = index_writes[0]
            lat = []
            t = time.perf_counter()
            for key, blob in objects.items():
                t1 = time.perf_counter()
                await s3("PUT", f"/bkt/{key}", blob)
                lat.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t
            per_put = (index_writes[0] - index0) / SERVICE_PUTS
            check(per_put >= 1, "services: a PUT updated no bucket index")
            emit("put", objects=SERVICE_PUTS, object_bytes=SERVICE_STRIPE,
                 index_write_fulls_per_put=per_put, **_pcts(lat),
                 **gbps(SERVICE_PUTS * SERVICE_STRIPE, wall))
            emit("put ops", per_put=op_split(SERVICE_PUTS),
                 put_ms=wall * 1e3 / SERVICE_PUTS)
            # b. a multipart upload
            t = time.perf_counter()
            _, body = await s3("POST", "/bkt/multi", query="uploads")
            upload = json.loads(body)["UploadId"]
            for n, part in enumerate(parts, start=1):
                await s3("PUT", "/bkt/multi", part,
                         query=f"uploadId={upload}&partNumber={n}")
            _, body = await s3("POST", "/bkt/multi", query=f"uploadId={upload}")
            wall = time.perf_counter() - t
            check(json.loads(body)["ETag"].endswith(f"-{SERVICE_PARTS}"),
                  f"services: multipart ETag {body!r}")
            emit("multipart", parts=SERVICE_PARTS,
                 part_bytes=SERVICE_PART_BYTES,
                 **gbps(SERVICE_PARTS * SERVICE_PART_BYTES, wall))
            # c. LIST
            t = time.perf_counter()
            _, body = await s3("GET", "/bkt")
            listing = json.loads(body)
            check(sorted(listing) == sorted([*objects, "multi"])
                  and all(listing[k]["size"] == SERVICE_STRIPE
                          for k in objects),
                  f"services: LIST gave {sorted(listing)[:4]}...")
            emit("list", keys=len(listing),
                 ms=(time.perf_counter() - t) * 1e3)
            # d. GETs and the multipart GET
            op_split(1)
            wall, mwall = await get_all("get", lambda wall: emit(
                "get ops", per_get=op_split(SERVICE_PUTS),
                get_ms=wall * 1e3 / SERVICE_PUTS))
            emit("get", objects=SERVICE_PUTS,
                 **gbps(SERVICE_PUTS * SERVICE_STRIPE, wall),
                 multipart_GB_per_s=SERVICE_PARTS * SERVICE_PART_BYTES
                 / mwall / 1e9)
            # e. range GETs of 1 MiB
            lat = []
            for key, blob in objects.items():
                off = int(rng.integers(0, SERVICE_STRIPE - SERVICE_RANGE_BYTES))
                end = off + SERVICE_RANGE_BYTES - 1
                t1 = time.perf_counter()
                h, got = await s3("GET", f"/bkt/{key}", want="206",
                                  headers={"range": f"bytes={off}-{end}"})
                lat.append((time.perf_counter() - t1) * 1e3)
                check(got == blob[off:end + 1]
                      and h["content-range"]
                      == f"bytes {off}-{end}/{SERVICE_STRIPE}",
                      f"services: range GET of {key} at {off} differs")
            emit("range get", gets=SERVICE_PUTS,
                 range_bytes=SERVICE_RANGE_BYTES, **_pcts(lat))
            # f. CephFS: two ranks, /d1 exported to rank 1
            mc = await MDSCluster(meta, data, n_ranks=2).start()
            fsc = CephFSMultiClient(mc, "smoke", renew_interval=0.01)
            for d in ("/d0", "/d1"):
                await fsc.mkdir(d)
            t = time.perf_counter()
            export = asyncio.create_task(mc.export_dir("/d1", 1))
            while not export.done():  # the holder complies on renewal
                await fsc.renew_all()
                await asyncio.sleep(0.01)
            await export
            export_ms = (time.perf_counter() - t) * 1e3
            check(mc.rank_of("/d1/f1") == 1 and mc.rank_of("/d0/f0") == 0,
                  "services: /d1 did not move to rank 1")
            t = time.perf_counter()
            for path, blob in files.items():
                await fsc.write(path, blob)
                await fsc.fsync(path)
            wall = time.perf_counter() - t
            emit("fs write", files=SERVICE_FILES,
                 file_bytes=SERVICE_FILE_BYTES, export_ms=export_ms,
                 **gbps(SERVICE_FILES * SERVICE_FILE_BYTES, wall))
            wall = await read_files(mc, "fs read")
            emit("fs read", **gbps(SERVICE_FILES * SERVICE_FILE_BYTES, wall))
            # g. a snapshot, a write after it, a rename across ranks
            await fsc.snap_create("/d0", "s")
            old = files["/d0/f0"]
            files["/d0/f0"] = seeded(SERVICE_FILE_BYTES)
            await fsc.write("/d0/f0", files["/d0/f0"])
            await fsc.fsync("/d0/f0")
            check(await fsc.read_snap("/d0", "s", "f0") == old,
                  "services: the snapshot lost f0's old bytes")
            t = time.perf_counter()
            await fsc.rename("/d0/f2", "/d1/f2-moved")
            rename_ms = (time.perf_counter() - t) * 1e3
            files["/d1/f2-moved"] = files.pop("/d0/f2")
            check("f2" not in await fsc.listdir("/d0")
                  and "f2-moved" in await fsc.listdir("/d1"),
                  "services: the cross-rank rename did not land once")
            await fsc.unmount()
            # h. rank 1 replaced: its journal replayed
            t = time.perf_counter()
            await mc.replace_rank(1)
            replace_ms = (time.perf_counter() - t) * 1e3
            wall = await read_files(mc, "after replace_rank")
            emit("mds", snapshot="s", rename_across_ranks_ms=rename_ms,
                 replace_rank_ms=replace_ms,
                 read_after_replace_GB_per_s=SERVICE_FILES
                 * SERVICE_FILE_BYTES / wall / 1e9)
            # i. lose the OSD in the most acting sets; read everything again
            client = rados._client
            p = client.osdmap.pools[data.pool_id]
            member = collections.Counter(
                a for pg in range(p.pg_num)
                for a in client.osdmap.pg_to_acting(p, pg)
                if a != CRUSH_ITEM_NONE)
            victim = min(member, key=lambda o: (-member[o], o))
            await cluster.kill_osd(victim)
            await client.mark_osd_down(victim)
            await client.refresh_map()
            wall, mwall = await get_all("degraded get")
            fs_wall = await read_files(mc, "degraded fs read")
            emit("degraded", lost_osd=victim,
                 get_GB_per_s=SERVICE_PUTS * SERVICE_STRIPE / wall / 1e9,
                 multipart_GB_per_s=SERVICE_PARTS * SERVICE_PART_BYTES
                 / mwall / 1e9,
                 fs_read_GB_per_s=SERVICE_FILES * SERVICE_FILE_BYTES
                 / fs_wall / 1e9)
            emit("counters", ec_cuda=queue.perf.dump(),
                 ec_plugin=PLUGIN_PERF.dump(), pagestore=store.perf.dump())
            return queue, store, index_writes[0]
        finally:
            if frontend is not None:
                await frontend.stop()
            await rados.shutdown()
            await cluster.stop()

    t_phase = time.perf_counter()
    _zero_counts()
    try:
        with _counting(slab, "slab_install", slab_calls["slab_install"]), \
                _counting(slab, "slab_gather", slab_calls["slab_gather"]):
            queue, store, index_writes = asyncio.run(
                asyncio.wait_for(run(), 300))
        counts, _ = _read_counts(device, "(services)")
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()
        osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
    check(PLUGIN_PERF.get("cpu_fallback") == 0
          and PLUGIN_PERF.get("device_failed") == 0,
          "services: the cuda plugin fell back or failed on the card")
    check(queue.perf.get("breaker_fallback") == 0,
          "services: the queue's breaker served a group off the card")
    check(queue.perf.get("dispatch") > 0, "services: the queue dispatched "
          "nothing")
    for name in ("apply_packedbit", "from_packedbit_paged"):
        check(counts[name] > 0, f"services: {name} never launched")
    check(store.device_installs > 0, "services: no device-native install")
    emit("launches", k4_apply_packedbit=counts["apply_packedbit"],
         k6_from_packedbit_paged=counts["from_packedbit_paged"],
         slab_install=slab_calls["slab_install"][0],
         slab_gather=slab_calls["slab_gather"][0],
         device_installs=store.device_installs,
         index_write_fulls=index_writes)
    print(f"services: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


# ------------------------------------------------------------ phase tools --

TOOLS_SWEEP_PLUGINS = "jerasure,isa,cuda"
TOOLS_SWEEP_SIZE = 4 << 20
TOOLS_SWEEP_ITERATIONS = 4
TOOLS_GATES = ("device-parity", "wire-floor", "qos", "tier", "chaos",
               "slow-ops", "crash", "full", "rebalance", "lifecycle")
TOOLS_GATE_TIMEOUT_S = 300
TOOLS_OSDS = 4
TOOLS_OBJECTS = 8
# the archives the port creates, each beside plugin=jerasure's of the
# same profile: (stripe width, profile)
TOOLS_CREATE = ((4096, ("technique=reed_sol_van", "k=8", "m=3")),
                (4096, ("technique=cauchy_good", "k=4", "m=2")))


def _archive_args(profile_dir: str):
    """non_regression arguments that name a corpus directory's profile."""
    parts = profile_dir.split()
    argv = ["--stripe-width", parts[1].split("=", 1)[1]]
    for kv in parts[2:]:
        argv += ["-P", kv]
    return parts[0].split("=", 1)[1], argv


def _tool(main, argv):
    """One in-process tool run: (rc, its stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def _tools_corpus(device, emit) -> None:
    """Every committed archive replayed by the port's non_regression, the
    plugin=tpu one under plugin=cuda on both lanes; then plugin=cuda
    archives created and checked in a temp --base, chunks equal to
    plugin=jerasure's created there."""
    import tempfile

    from ceph_tpu_torch.tools import non_regression

    corpus = os.path.join(ROOT, "corpus")
    dirs = sorted(d for d in os.listdir(corpus) if d.startswith("plugin="))
    check(len(dirs) >= 6, f"tools: the corpus shrank: {dirs}")
    for d in dirs:
        plugin, argv = _archive_args(d)
        lanes = ("1", "0") if plugin == "tpu" else ("1",)
        for lane in lanes:
            with _env(CEPH_TPU_PACKEDBIT=lane):
                t0 = time.perf_counter()
                rc, _ = _tool(non_regression.main, [
                    "--check", "--base", corpus, "--device", str(device),
                    "--plugin", "cuda" if plugin == "tpu" else plugin]
                    + argv)
            check(rc == 0, f"tools: --check of {d!r} exited {rc}")
            emit("corpus", archive=d, plugin="cuda" if plugin == "tpu"
                 else plugin, packedbit=lane,
                 ms=(time.perf_counter() - t0) * 1e3)
    with tempfile.TemporaryDirectory() as base:
        for width, profile in TOOLS_CREATE:
            params = [a for kv in profile for a in ("-P", kv)]
            common = ["--base", base, "--stripe-width", str(width),
                      "--device", str(device)] + params
            for plugin in ("jerasure", "cuda"):
                rc, _ = _tool(non_regression.main,
                              ["--create", "--plugin", plugin] + common)
                check(rc == 0, f"tools: --create {plugin} {profile} "
                      f"exited {rc}")
            for lane in ("1", "0"):
                with _env(CEPH_TPU_PACKEDBIT=lane):
                    rc, _ = _tool(non_regression.main,
                                  ["--check", "--plugin", "cuda"] + common)
                check(rc == 0, f"tools: --check cuda {profile} "
                      f"(packedbit={lane}) exited {rc}")
            names = [f"plugin={p} stripe-width={width} " + " ".join(profile)
                     for p in ("jerasure", "cuda")]
            chunks = [sorted(os.listdir(os.path.join(base, n)))
                      for n in names]
            check(chunks[0] == chunks[1], f"tools: {profile}: chunk files "
                  f"differ: {chunks}")
            for c in chunks[0]:
                with open(os.path.join(base, names[0], c), "rb") as f:
                    want = f.read()
                with open(os.path.join(base, names[1], c), "rb") as f:
                    check(f.read() == want, f"tools: created plugin=cuda "
                          f"{profile} chunk {c} differs from jerasure's")
            emit("create", profile=" ".join(profile), stripe_width=width,
                 files=len(chunks[0]), equal_to="plugin=jerasure")


def _tools_sweep(device, emit) -> None:
    """bench_suite's sweep over TOOLS_SWEEP_PLUGINS at 4 MiB: each cell's
    MB/s, the plugins side by side at one (technique, k, m, workload)."""
    from ceph_tpu_torch.tools import bench_suite

    argv = ["--plugins", TOOLS_SWEEP_PLUGINS, "--size", str(TOOLS_SWEEP_SIZE),
            "--iterations", str(TOOLS_SWEEP_ITERATIONS),
            "--device", str(device)]
    t0 = time.perf_counter()
    rc, out = _tool(bench_suite.main, argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"tools: bench_suite exited {rc}")
    rows = [json.loads(line) for line in out.splitlines() if line.strip()]
    want = (sum(len(ms) for ms in bench_suite.K2MS.values()) * 2 * 2
            * len(TOOLS_SWEEP_PLUGINS.split(",")))
    check(len(rows) == want, f"tools: bench_suite printed {len(rows)} "
          f"cells, not {want}")
    cells = collections.defaultdict(dict)
    for r in rows:
        cells[(r["technique"], r["k"], r["m"], r["workload"])][
            r["plugin"]] = r["mbps"]
    for (technique, k, m, workload), mbps in sorted(cells.items()):
        emit("sweep", technique=technique, k=k, m=m, workload=workload,
             size=TOOLS_SWEEP_SIZE, MBps=mbps)
    emit("sweep total", cells=len(rows), wall_s=wall)


def _tools_gates(device, emit) -> None:
    """The ten cluster gates, each a `python -m
    ceph_tpu_torch.tools.non_regression --<gate> --device <device>`
    process at its default seconds."""
    for gate in TOOLS_GATES:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ceph_tpu_torch.tools.non_regression",
             f"--{gate}", "--device", str(device)],
            cwd=ROOT, capture_output=True, text=True,
            timeout=TOOLS_GATE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        extra = {}
        if gate == "device-parity":
            for line in proc.stdout.splitlines():
                for arm in ("device", "host"):
                    prefix = f"device parity {arm} child: "
                    if line.startswith(prefix):
                        extra[arm] = json.loads(line[len(prefix):])
        emit("gate", gate=gate, rc=proc.returncode, wall_s=wall, **extra,
             last=(proc.stdout.strip().splitlines() or [""])[-1][:300])
        if proc.returncode:
            sys.stderr.write(proc.stdout[-3000:] + proc.stderr[-3000:])
        check(proc.returncode == 0, f"tools: --{gate} exited "
              f"{proc.returncode}")
        if gate == "device-parity":
            dev = extra.get("device", {})
            check(dev.get("device_arm") and dev.get("device_installs", 0)
                  + dev.get("h2d_installs", 0) > 0,
                  f"tools: the parity device child's arm did not engage: "
                  f"{extra}")
            check(not extra.get("host", {}).get("device_arm", 1),
                  f"tools: the parity host child engaged the device arm: "
                  f"{extra}")


def _tools_operator(device, emit) -> None:
    """The operator tools against a disk-backed cluster with the mgr on
    `device`: the ceph CLI, trace_export of one put, the stores of a
    stopped OSD and mon, dencoder, ceph_volume and cephadm."""
    import asyncio
    import tempfile

    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.vstart import Cluster
    from ceph_tpu_torch.tools import (ceph, ceph_volume, cephadm, dencoder,
                                      monstore_tool, objectstore_tool,
                                      trace_export)

    rng = np.random.default_rng(SEED + 14)
    blobs = {f"t{i}": rng.integers(0, 256, OBJECT_SIZE, dtype=np.uint8)
             .tobytes() for i in range(TOOLS_OBJECTS)}

    async def run(data_dir):
        asok = os.path.join(data_dir, "asok")
        os.makedirs(asok)
        conf = {"osd_ec_device": str(device), "osd_auto_repair": False,
                "client_op_timeout": 60.0, "osd_heartbeat_interval": 0.2,
                "admin_socket_dir": asok, "ms_local_fastpath": False}
        cluster = Cluster(n_osds=TOOLS_OSDS, conf=dict(conf), with_mgr=True,
                          data_dir=os.path.join(data_dir, "cluster"))
        await cluster.start()
        stopped = False
        try:
            c = await cluster.client()
            pool = await c.create_pool("tools", pg_num=8, profile={
                "plugin": "cuda", "technique": "reed_sol_van",
                "k": "2", "m": "1"})
            t0 = time.perf_counter()
            for oid, data in blobs.items():
                await c.put(pool, oid, data)
            put_s = time.perf_counter() - t0
            for oid, data in blobs.items():
                check(await c.get(pool, oid) == data,
                      f"tools: read of {oid} differs")
            mon = f"{cluster.mons[0].addr[0]}:{cluster.mons[0].addr[1]}"
            for words in (("status",), ("health",), ("osd", "df"),
                          ("osd", "tree")):
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rc = await ceph.run(ceph.parse_args(
                        ["--mon", mon, "--format", "json", *words]))
                check(rc == 0, f"tools: ceph {' '.join(words)} exited {rc}")
                doc = json.loads(out.getvalue())
                if words == ("status",):
                    check(doc["osdmap"]["num_up_osds"] == TOOLS_OSDS,
                          f"tools: ceph status: {doc['osdmap']}")
                emit("ceph", command=" ".join(words),
                     summary=(doc.get("health", doc.get("status")) if isinstance(doc, dict)
                              else f"{len(doc)} rows"))
            root = [d for d in c.tracer.dump()
                    if d["name"].startswith("client_op write")][-1]
            jaeger = os.path.join(data_dir, "trace.json")
            rc = await asyncio.to_thread(trace_export.main, [
                "--asok-dir", asok, "--trace", root["trace_id"],
                "-o", jaeger])
            check(rc == 0, f"tools: trace_export exited {rc}")
            with open(jaeger) as f:
                spans = json.load(f)["data"][0]["spans"]
            names = {s["operationName"] for s in spans}
            check({"osd_op write", "ec write"} <= names,
                  f"tools: the exported trace lacks the OSD spans: {names}")
            emit("trace_export", spans=len(spans),
                 sub_writes=sum(n.startswith("ec_sub_write")
                                for n in (s["operationName"] for s in spans)))
            victim = max(cluster.osds)
            path = cluster.osds[victim].store.path
            await cluster.kill_osd(victim)
            rc, out = _tool(objectstore_tool.main,
                            ["--data-path", path, "--op", "list"])
            check(rc == 0 and out.strip(), f"tools: objectstore_tool --op "
                  f"list on osd.{victim} exited {rc}")
            emit("objectstore_tool", osd=victim,
                 lines=len(out.strip().splitlines()))
            await c.stop()
            await cluster.stop()
            stopped = True
            return put_s
        finally:
            if not stopped:
                await cluster.stop()

    with tempfile.TemporaryDirectory() as data_dir:
        try:
            put_s = asyncio.run(asyncio.wait_for(run(data_dir), 300))
        finally:
            if osdmod._BATCH_QUEUE is not None:
                osdmod._BATCH_QUEUE.close()
            osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
        emit("cluster", objects=TOOLS_OBJECTS, object_bytes=OBJECT_SIZE,
             put_GB_per_s=TOOLS_OBJECTS * OBJECT_SIZE / put_s / 1e9)
        store = os.path.join(data_dir, "cluster", "mon.0", "store.db")
        rc, out = _tool(monstore_tool.main, [store, "dump"])
        check(rc == 0, f"tools: monstore_tool dump exited {rc}")
        emit("monstore_tool", last_committed=json.loads(out)[
            "last_committed"])
        rc, out = _tool(dencoder.main, ["roundtrip"])
        check(rc == 0, f"tools: dencoder roundtrip exited {rc}")
        emit("dencoder", result=out.strip().splitlines()[-1])
        vol = os.path.join(data_dir, "volumes")
        for argv in (["prepare", "--base", vol, "--osd-id", "0"],
                     ["prepare", "--base", vol, "--osd-id", "1"],
                     ["zap", "--base", vol, "--osd-id", "1", "--yes"]):
            rc, _ = _tool(ceph_volume.main, argv)
            check(rc == 0, f"tools: ceph_volume {argv[0]} exited {rc}")
        rc, out = _tool(ceph_volume.main, ["list", "--base", vol])
        ids = [r["osd_id"] for r in json.loads(out)]
        check(rc == 0 and ids == [0], f"tools: ceph_volume list: {ids}")
        emit("ceph_volume", prepared=2, zapped=1, listed=ids)
        clusters = os.path.join(data_dir, "clusters")
        t0 = time.perf_counter()
        rc, _ = _tool(cephadm.main, ["--data-root", clusters, "bootstrap",
                                     "--name", "c1", "--osds", "3",
                                     "--device", str(device)])
        boot_s = time.perf_counter() - t0
        spec_path = os.path.join(clusters, "c1", "cluster.json")
        pid = 0
        try:
            check(rc == 0, f"tools: cephadm bootstrap exited {rc}")
            with open(spec_path) as f:
                pid = json.load(f)["pid"]
            rc, out = _tool(cephadm.main, ["--data-root", clusters, "ls",
                                           "--format", "json"])
            check(rc == 0 and "c1" in out, f"tools: cephadm ls: {out!r}")
            rc, _ = _tool(cephadm.main, ["--data-root", clusters,
                                         "rm-cluster", "--name", "c1",
                                         "--force"])
            check(rc == 0 and not os.path.exists(spec_path),
                  f"tools: cephadm rm-cluster exited {rc}")
        finally:
            if pid and cephadm._alive(pid):
                os.kill(pid, 9)
        emit("cephadm", bootstrap_s=boot_s, osds=3)


def _tools_lint(emit) -> None:
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"tools: the lint exited {proc.returncode}: "
          f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    check(doc["ok"] and doc["findings"] == [], f"tools: lint findings: "
          f"{doc['findings']}")
    emit("lint", files=doc["files_scanned"], findings=0)


def phase_tools(device, card):
    """The offline and operator tools on the card: the corpus replays and
    creates, bench_suite's sweep, the ten cluster gates as processes, the
    operator tools on a disk-backed cluster, and the lint.  Every launch
    count is set to 0 just before and read just after; only this process's
    launches count (the gates' report their stores' counters).  Returns
    each kernel's launch count in this run."""

    def emit(step, **numbers):
        print("tools " + json.dumps({"step": step, **numbers, "card": card}),
              flush=True)

    t_phase = time.perf_counter()
    _zero_counts()
    _tools_corpus(device, emit)
    _tools_sweep(device, emit)
    _tools_gates(device, emit)
    _tools_operator(device, emit)
    counts, _ = _read_counts(device, "(tools)")
    _tools_lint(emit)
    for name in ("apply_packedbit", "apply_bytes_w8", "xor_schedule"):
        check(counts[name] > 0, f"tools: {name} never launched")
    emit("launches", **{name: n for name, n in counts.items()})
    print(f"tools: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


# ------------------------------------------------------------- phase wire --

WIRE_FRAMES = 12             # corpus frames of step b
WIRE_MESSAGES = 48           # messages of a messenger turn ...
WIRE_MESSAGE_BYTES = 1 << 20  # ... of up to 1 MiB
WIRE_OBJECTS = 16            # 4 MiB puts and gets of a cluster turn
WIRE_ARMS = ("native", "python", "python", "native")


def _wire_entry_points(emit) -> None:
    """Step b: every wire_* and wirepy_* entry point against the python arm
    (the process checksum a segment, joins and slices) on the committed
    frame corpus, each frame cut into awkward segments."""
    import socket

    from ceph_tpu_torch.native import bridge
    from ceph_tpu_torch.utils import checksum

    wire_dir = os.path.join(ROOT, "corpus", "wire")
    names = sorted(n for n in os.listdir(wire_dir)
                   if n.endswith(".frame"))[:WIRE_FRAMES]
    check(len(names) == WIRE_FRAMES, f"wire corpus holds {len(names)} frames")
    calls = collections.Counter()
    t0 = time.perf_counter()
    for name in names:
        with open(os.path.join(wire_dir, name), "rb") as f:
            raw = f.read()
        c1, c2 = max(1, len(raw) // 3), max(2, 2 * len(raw) // 3)
        segs = [raw[:c1], bytearray(raw[c1:c2]), memoryview(raw)[c2:], b""]
        want = 0
        for s in segs:
            want = checksum.checksum(s, want)

        def same(fn, got, expect):
            calls[fn] += 1
            check(got == expect, f"wire {name}: {fn} gave {got!r}, the "
                  f"python arm {expect!r}")

        same("crc32c", bridge.crc32c(raw, 7), checksum.checksum(raw, 7))
        same("wire_crc_batch", bridge.wire_crc_batch([segs, segs[1:]],
                                                     seeds=[0, 5]),
             [want, checksum.checksum(raw[c1:], 5)])
        same("wirepy_crc_chain", bridge.wirepy_crc_chain(list(segs)), want)
        for fn in ("wire_gather", "wirepy_gather"):
            out = bytearray(len(raw))
            n = getattr(bridge, fn)(list(segs), out)
            same(fn, (n, bytes(out)), (len(raw), raw))
        dst = bytearray(len(raw))
        same("wire_copy_crc32c", (bridge.wire_copy_crc32c(raw, dst, 3),
                                  bytes(dst)),
             (checksum.checksum(raw, 3), raw))
        offs, lens = [0, c1, c2], [c1, c2 - c1, len(raw) - c2]
        wants = [checksum.checksum(raw[o:o + n]) for o, n in zip(offs, lens)]
        for fn in ("wire_verify_regions", "wirepy_verify_regions"):
            same(fn, getattr(bridge, fn)(raw, offs, lens, wants), -1)
            same(fn, getattr(bridge, fn)(raw, offs, lens,
                                         [wants[0], wants[1] ^ 1, wants[2]]),
                 1)
        back = bytearray(len(raw))
        rc = bridge.wire_scatter([segs[2], segs[0], segs[1]], [c2, 0, c1],
                                 back, want_crcs=[wants[2], wants[0],
                                                  wants[1]])
        same("wire_scatter", (rc, bytes(back)), ((3, -1), raw))
        parts = [bytearray(n) for n in lens]
        n = bridge.wirepy_scatter_from(raw, offs, parts)
        same("wirepy_scatter_from", (n, b"".join(parts)), (len(raw), raw))
        for fn in ("wire_writev", "wirepy_writev"):
            a, z = socket.socketpair()
            try:
                a.setblocking(False)
                sent = getattr(bridge, fn)(a.fileno(), list(segs), 0)
                got = b""
                while len(got) < sent:
                    got += z.recv(1 << 20)
                same(fn, (sent, got), (len(raw), raw))
            finally:
                a.close()
                z.close()
    emit("entry points", frames=len(names),
         frame_bytes=sum(os.path.getsize(os.path.join(wire_dir, n))
                         for n in names),
         calls=dict(calls), seconds=time.perf_counter() - t0)


def _wire_messengers(emit) -> dict:
    """Step c: two of the port's messengers over TCP, the native arm and
    the python arm in turns; returns MB/s of each arm's turns."""
    import asyncio

    from ceph_tpu_torch.rados.messenger import Messenger, message

    @message(9821)
    class MWireSmoke:
        seq: int = 0
        blob: bytes = b""

    rng = np.random.default_rng(SEED + 20)
    sizes = rng.integers(1, WIRE_MESSAGE_BYTES + 1, WIRE_MESSAGES)
    blobs = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for n in sizes]
    total = sum(len(b) for b in blobs)
    want = [(i, b) for i, b in enumerate(blobs)]

    async def turn(native: bool, inject: bool):
        conf = {"ms_wirepath_native": native}
        if inject:
            conf.update(ms_inject_socket_failures=9, ms_inject_dup_frames=5)
        server = Messenger("server", dict(conf), entity_type="osd")
        client = Messenger("client", dict(conf), entity_type="osd")
        addr = await server.bind()
        got = []
        done = asyncio.Event()

        async def dispatch(conn, msg):
            got.append((msg.seq, bytes(msg.blob)))
            if len(got) >= WIRE_MESSAGES:
                done.set()

        server.dispatcher = dispatch
        t0 = time.perf_counter()
        for i, b in enumerate(blobs):
            await client.send(addr, MWireSmoke(seq=i, blob=b), retries=10)
        await asyncio.wait_for(done.wait(), 120)
        seconds = time.perf_counter() - t0
        await asyncio.sleep(0.2)  # a late duplicate would show here
        perf = client.perf.dump()
        kinds = (perf["wirepath_kind"], server.perf.dump()["wirepath_kind"])
        await client.shutdown()
        await server.shutdown()
        return got, seconds, perf, kinds

    rates = collections.defaultdict(list)
    for arm in WIRE_ARMS:
        native = arm == "native"
        for inject in (True, False):
            got, seconds, perf, kinds = asyncio.run(turn(native, inject))
            check(got == want, f"wire messengers ({arm}, injected={inject}): "
                  "dispatch not exactly once, in order, byte-identical")
            check(kinds == ((1, 1) if native else (0, 0)),
                  f"wire messengers ({arm}): wirepath_kind {kinds}")
            check((perf["native_tx_calls"] > 0) == native,
                  f"wire messengers ({arm}): native_tx_calls "
                  f"{perf['native_tx_calls']}")
            if not inject:
                rates[arm].append(total / seconds / 1e6)
            emit("messengers", arm=arm, injected=inject,
                 messages=WIRE_MESSAGES, bytes=total, seconds=seconds,
                 MB_per_s=total / seconds / 1e6,
                 native_tx_calls=perf["native_tx_calls"],
                 native_rx_calls=perf["native_rx_calls"],
                 native_bytes=perf["native_bytes"], wirepath_kind=kinds[0])
    return dict(rates)


def _wire_process_reactors(device, emit) -> None:
    """Step c, process reactors: a messenger pair with ms_reactor_mode=
    process forks its workers from this process, which holds a CUDA
    context by now; the workers never touch CUDA.  Striped messages go
    through them on the native arm, exactly once and in order."""
    import asyncio

    import torch

    from ceph_tpu_torch.rados.messenger import Messenger, message

    @message(9822)
    class MWireProc:
        seq: int = 0
        kind: str = "a"
        data: bytes = b""
        gseq: int = 0

    MWireProc.LANE_STRIPE = True
    MWireProc.BLOB_ATTR = "data"
    MWireProc.BLOB_VIEW_OK = True
    MWireProc.FIXED_FIELDS = [("seq", "q"), ("kind", "s"), ("data", "y"),
                              ("gseq", "Q")]
    conf = {"ms_reactor_mode": "process", "ms_lanes_per_peer": 3,
            "ms_async_op_threads": 2, "ms_wirepath_native": True,
            "osd_ec_device": str(device)}
    payloads = [bytes([(i * 13 + j) & 0xFF for j in range(256)])
                * (1 + (i % 5) * 400) for i in range(WIRE_MESSAGES)]
    cuda_live = torch.cuda.is_initialized()

    async def go():
        a = Messenger("a", dict(conf))
        b = Messenger("b", dict(conf), entity_type="osd")
        await a.bind()
        addr_b = tuple(await b.bind())
        got = []
        done = asyncio.Event()

        async def disp(conn, msg):
            got.append((msg.seq, bytes(msg.data)))
            if len(got) >= len(payloads):
                done.set()

        b.dispatcher = disp
        for i, p in enumerate(payloads):
            await a.send(addr_b, MWireProc(seq=i, data=p))
        await asyncio.wait_for(done.wait(), 60)
        dump = a.dump_reactors()
        await a.shutdown()
        await b.shutdown()
        return got, dump

    got, dump = asyncio.run(go())
    check(got == list(enumerate(payloads)),
          "process reactors: dispatch not exactly once and in order")
    check(dump["reactor_mode"] == "process" and all(dump["worker_pids"]),
          "process reactors: no worker process ran")
    emit("process reactors", cuda_context_live_at_fork=cuda_live,
         workers=len(dump["worker_pids"]), messages=len(payloads),
         worker_wirepath_kind=dump["proc_perf"].get("wirepath_kind"),
         worker_tx_bytes=dump["proc_perf"].get("tx_bytes"))


def _wire_cluster(device, emit) -> dict:
    """Step d: the osd phase's 12-OSD plugin=cuda k=8 m=3 cluster over TCP
    (ms_local_fastpath off, as the --wire-floor gate runs: colocated
    daemons would take the in-process fastpath and never reach the wire),
    one cluster a turn with every messenger on the native or the python
    arm; returns each arm's put and get GB/s."""
    import asyncio

    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.vstart import Cluster

    rng = np.random.default_rng(SEED + 21)
    objects = {f"wire-{i}": rng.integers(0, 256, OBJECT_SIZE,
                                         dtype=np.uint8).tobytes()
               for i in range(WIRE_OBJECTS)}
    total = OBJECT_SIZE * WIRE_OBJECTS

    async def turn(arm):
        conf = {"osd_ec_device": str(device), "osd_auto_repair": False,
                "client_op_timeout": 60.0, "osd_op_history_size": 4096,
                "ms_local_fastpath": False,
                "ms_wirepath_native": arm == "native"}
        cluster = Cluster(n_osds=OSD_COUNT, conf=conf)
        await cluster.start()
        client = await cluster.client()
        try:
            pool = await client.create_pool(
                "wire", "ec", pg_num=OSD_PG_NUM, profile=dict(OSD_POOL))
            gate = asyncio.Semaphore(OSD_IN_FLIGHT)

            async def one(fn, oid):
                async with gate:
                    return await fn(oid)

            t0 = time.perf_counter()
            await asyncio.gather(*(one(lambda o: client.put(
                pool, o, objects[o]), oid) for oid in objects))
            put_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            got = await asyncio.gather(*(one(lambda o: client.get(pool, o),
                                             oid) for oid in objects))
            get_s = time.perf_counter() - t0
            for oid, data in zip(objects, got):
                check(bytes(data) == objects[oid],
                      f"wire cluster ({arm}): {oid} read back wrong")
            osds = list(cluster.osds.values())
            steps = _op_step_gaps(osds, "write", set())
            msgrs = [o.messenger for o in osds] + [client.messenger]
            kinds = {m.perf.get("wirepath_kind") for m in msgrs}
            tx = sum(m.perf.get("native_tx_calls") for m in msgrs)
            frames = sum(m.perf.get("tx_msgs") for m in msgrs)
            return put_s, get_s, steps, kinds, tx, frames
        finally:
            await client.stop()
            await cluster.stop()

    rates = collections.defaultdict(list)
    try:
        for arm in WIRE_ARMS:
            try:
                put_s, get_s, steps, kinds, tx, frames = asyncio.run(
                    asyncio.wait_for(turn(arm), 300))
            finally:
                if osdmod._BATCH_QUEUE is not None:
                    osdmod._BATCH_QUEUE.close()
                osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
            check(kinds == ({1} if arm == "native" else {0}),
                  f"wire cluster ({arm}): wirepath_kind {kinds}")
            check((tx > 0) == (arm == "native") and frames > 0,
                  f"wire cluster ({arm}): native_tx_calls {tx}, tx_msgs "
                  f"{frames}")
            rates[arm].append((total / put_s / 1e9, total / get_s / 1e9))
            sub = steps.get("encoded->sub_writes_sent", {})
            emit("cluster", arm=arm, transport="tcp", objects=WIRE_OBJECTS,
                 put_GB_per_s=total / put_s / 1e9,
                 get_GB_per_s=total / get_s / 1e9,
                 sub_write_step_p50_us=sub.get("p50_us"),
                 sub_write_step_count=sub.get("count"),
                 wirepath_kind=kinds.pop(), native_tx_calls=tx,
                 tx_msgs=frames)
    finally:
        osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
    return dict(rates)


def phase_wire(device, card):
    """The native wire path on the card host: the selftest, every entry
    point against the python arm, a messenger pair and the 12-OSD cluster
    on each arm in turns.  Returns each kernel's launch count in this run
    (the cluster's)."""
    from ceph_tpu_torch.native import bridge
    from ceph_tpu_torch.utils import wirepath

    def emit(step, **numbers):
        print("wire " + json.dumps({"step": step, **numbers, "card": card}),
              flush=True)

    t_phase = time.perf_counter()
    check(wirepath.kind() == "native" and wirepath.impl() is bridge,
          f"wire: the port resolved the {wirepath.kind()} arm on the card "
          "host")
    check(bridge.wirepath_selftest() == 0, "wire: wirepath selftest failed")
    emit("resolve", kind=wirepath.kind(), selftest=0,
         wire_library=os.path.basename(bridge.wire_library_path()),
         wirepy_library=os.path.basename(bridge.wirepy_library_path()),
         cpu=_cpu_model(), cpus=os.cpu_count())
    _zero_counts()
    _wire_entry_points(emit)
    rates = _wire_messengers(emit)
    _wire_process_reactors(device, emit)
    cluster = _wire_cluster(device, emit)
    counts, _ = _read_counts(device, "(wire)")
    check(counts["apply_packedbit"] > 0, "wire: K4 never launched")
    emit("summary", messenger_MB_per_s=rates, cluster_GB_per_s={
        arm: {"put": [p for p, _ in v], "get": [g for _, g in v]}
        for arm, v in cluster.items()})
    print(f"wire: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


# ------------------------------------------------------------- phase mesh --

MESH_OBJECTS = 64            # writes of a turn of step b
MESH_OSD_OBJECTS = 12        # concurrent puts of step c, 50,000 bytes each
MESH_OSD_POOL = {"plugin": "jerasure", "technique": "reed_sol_van",
                 "k": "2", "m": "1"}


def _mesh_lanes(device, mesh, emit) -> dict:
    """Step a: the six lanes on one 4 MiB k=8 m=3 object's rows through a
    queue on the mesh and a mesh=False queue (launches uncounted), each
    against the other and the CPU codec.  Returns per lane the launches of
    its kernel and the mesh queue's dispatches."""
    import torch

    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
    from ceph_tpu_torch.ops import gf2 as lane
    from ceph_tpu_torch.parallel.service import BatchingQueue
    from ceph_tpu_torch.rados import ecutil
    from ceph_tpu_torch.utils.cudadev import resolve_device

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    cpu = _codec("jerasure", "cpu", technique="reed_sol_van", k=8, m=3)
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * STRIPE_UNIT)
    obj = np.random.default_rng(SEED + 30).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    shards = ecutil.batched_encode(cpu, sinfo, obj)
    rows = np.stack(shards[:8])
    parity = np.stack(shards[8:])
    bm = matrix_to_bitmatrix(codec.matrix, 8)
    lost = (0, 4, 7)
    chosen, inv = codec.decode_selection(set(lost), set(range(11)) - set(lost))
    decode = resident_decode_bitmatrix(
        matrix_to_bitmatrix(inv[list(lost)], 8), chosen)
    with _uncounted(device):
        data = torch.from_numpy(rows).to(device)
        words = lane.gf2_encode_packedbit_resident(bm, data)[1]
        bits = lane.unpack_bits_bytes(data, 8)
    damaged = words.clone()
    for c in lost:
        damaged[c * 8:(c + 1) * 8] = 0
    # lane -> (packed-bit lane switch, kernel, submit call)
    lanes = {
        "packedbit": ("1", "apply_packedbit", lambda q: q.submit_packedbit(
            bm.astype(np.uint8), rows, 8, 3)),
        "packedbit_resident": ("1", "apply_packedbit",
                               lambda q: q.submit_packedbit_resident(
                                   bm.astype(np.uint8), rows, 8, 3)),
        "packedbit_planes": ("1", "xor_schedule",
                             lambda q: q.submit_packedbit_planes(
                                 decode, damaged, 8, len(lost))),
        "packed": ("0", "apply_bytes_w8", lambda q: q.submit(
            bm.astype(np.int8), rows, 8, 3)),
        "resident": ("0", "gf2_matmul", lambda q: q.submit_resident(
            bm.astype(np.int8), rows, 8, 3)),
        "planar": ("0", "gf2_matmul", lambda q: q.submit_planar(
            bm.astype(np.int8), bits, 8, 3)),
    }

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def against_cpu(name, out):
        """The lane's product held against the CPU codec's shards."""
        with _uncounted(device):
            if name in ("packedbit", "packed"):
                got = out
            elif name in ("packedbit_resident", "resident"):
                got = out[0]
                planes = (lane.from_packedbit(out[1], 11)
                          if name == "packedbit_resident"
                          else lane.from_planar(out[1], 8, 11))
                check(np.array_equal(
                    host(planes)[:, :rows.shape[1]],
                    np.concatenate([rows, parity])),
                      f"mesh {name}: planes differ from the CPU codec's")
            elif name == "packedbit_planes":
                rebuilt = host(lane.from_packedbit(out, len(lost)))
                check(all(np.array_equal(rebuilt[i, :rows.shape[1]], rows[c])
                          for i, c in enumerate(lost)),
                      "mesh packedbit_planes: rebuilt chunks wrong")
                return
            else:  # planar
                got = host(lane.from_planar(out, 8, 3))
        check(np.array_equal(host(got), parity),
              f"mesh {name}: parity differs from the CPU codec's")

    on_mesh = BatchingQueue(device=device, max_delay=60.0, mesh=mesh)
    single = BatchingQueue(device=device, max_delay=60.0, mesh=False)
    out = {}
    try:
        check(on_mesh.mesh is mesh and single.mesh is None,
              "mesh: the queues did not take the mesh as given")
        for name, (switch, kernel, submit) in lanes.items():
            with _env(CEPH_TPU_PACKEDBIT=switch):
                fn = _wrappers()[kernel]
                sync(device)
                before = (fn.launches, on_mesh.dispatches,
                          on_mesh.sharded_dispatches, mesh.shard_puts)
                fut = submit(on_mesh)
                on_mesh.flush()
                got = fut.result(timeout=120)
                sync(device)
                launches = fn.launches - before[0]
                dispatches = on_mesh.dispatches - before[1]
                sharded = on_mesh.sharded_dispatches - before[2]
                puts = mesh.shard_puts - before[3]
                with _uncounted(device):
                    fut = submit(single)
                    single.flush()
                    want = fut.result(timeout=120)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if isinstance(g, torch.Tensor):
                    check(g.device == resolve_device(device),
                          f"mesh {name}: a product is on {g.device}")
                check(np.array_equal(host(g), host(w)),
                      f"mesh {name}: differs from the mesh=False queue")
            against_cpu(name, got)
            check(sharded == dispatches == puts == 1,
                  f"mesh {name}: {dispatches} dispatches, {sharded} "
                  f"sharded, {puts} shard puts")
            check(launches == mesh.n_devices * dispatches,
                  f"mesh {name}: {launches} {kernel} launches for "
                  f"{dispatches} dispatch on {mesh.n_devices} shards")
            out[name] = {"kernel": kernel, "launches": launches,
                         "dispatches": dispatches}
            emit("lane", lane=name, kernel=kernel, launches=launches,
                 dispatches=dispatches, sharded_dispatches=sharded,
                 equal_to_single_device=True, equal_to_cpu_codec=True)
    finally:
        on_mesh.close()
        single.close()
    return out


def _mesh_writes(device, mesh, emit) -> dict:
    """Step b: 64 4 MiB writes through ecutil into a queue on the mesh and
    a mesh=False queue, in turns; GB/s of each and their ratio."""
    import asyncio

    from ceph_tpu_torch.ops import cuda_packedbit
    from ceph_tpu_torch.parallel.service import BatchingQueue
    from ceph_tpu_torch.rados import ecutil

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    sinfo = ecutil.StripeInfo(k=8, stripe_width=8 * STRIPE_UNIT)
    rng = np.random.default_rng(SEED + 31)
    objs = [rng.integers(0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
            for _ in range(MESH_OBJECTS)]
    total = OBJECT_SIZE * MESH_OBJECTS

    async def writes(q):
        return await asyncio.gather(*(ecutil.batched_encode_async(
            codec, sinfo, o, queue=q) for o in objs))

    queues = {"mesh": BatchingQueue(device=device, mesh=mesh),
              "single": BatchingQueue(device=device, mesh=False)}
    rates = collections.defaultdict(list)
    want = None
    try:
        for arm in ("mesh", "single", "single", "mesh"):
            q = queues[arm]
            d0, s0 = q.dispatches, q.sharded_dispatches
            k4 = cuda_packedbit.apply_packedbit.launches
            ctx = _uncounted(device) if arm == "single" else \
                contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                got = asyncio.run(writes(q))
                seconds = time.perf_counter() - t0
                launches = cuda_packedbit.apply_packedbit.launches - k4
            if want is None:
                want = got
            check(all(len(g) == len(w) == 11 and all(
                np.array_equal(a, b) for a, b in zip(g, w))
                for g, w in zip(got, want)),
                f"mesh writes ({arm}): shards differ from the first turn's")
            dispatches = q.dispatches - d0
            sharded = q.sharded_dispatches - s0
            if arm == "mesh":
                check(sharded == dispatches > 0
                      and launches == mesh.n_devices * dispatches,
                      f"mesh writes: {dispatches} dispatches, {sharded} "
                      f"sharded, {launches} K4 launches")
            else:
                check(sharded == 0, "mesh=False queue sharded a dispatch")
            rates[arm].append(total / seconds / 1e9)
            emit("writes", arm=arm, objects=MESH_OBJECTS, seconds=seconds,
                 GB_per_s=total / seconds / 1e9, dispatches=dispatches,
                 sharded_dispatches=sharded,
                 k4_launches=launches if arm == "mesh" else None)
    finally:
        for q in queues.values():
            q.close()
    mesh_gbps = statistics.median(rates["mesh"])
    single_gbps = statistics.median(rates["single"])
    emit("writes summary", mesh_GB_per_s=rates["mesh"],
         single_GB_per_s=rates["single"],
         mesh_vs_single_ratio=mesh_gbps / single_gbps)
    return dict(rates)


def _mesh_cluster(device, mesh, emit) -> None:
    """Step c: a 3-OSD cluster on the card under CEPH_TPU_MESH=1 with
    concurrent puts of 12 objects (tests/test_mesh.py's case): the puts
    coalesce, every dispatch rides the mesh, every get reads back."""
    import asyncio

    from ceph_tpu_torch.rados import osd as osdmod
    from ceph_tpu_torch.rados.vstart import Cluster

    rng = np.random.default_rng(SEED + 32)
    blobs = [rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
             for _ in range(MESH_OSD_OBJECTS)]
    kernels = ("apply_packedbit", "xor_schedule", "apply_bytes_w8",
               "gf2_matmul")

    async def go():
        cluster = Cluster(n_osds=3, conf={
            "osd_ec_device": str(device), "osd_auto_repair": False,
            "client_op_timeout": 60.0})
        await cluster.start()
        client = await cluster.client()
        try:
            pool = await client.create_pool("mq", profile=dict(MESH_OSD_POOL))
            q = osdmod.shared_batching_queue(device)
            check(q is not None and q.mesh is mesh,
                  "mesh cluster: the OSDs' queue is not on the mesh")
            await client.put(pool, "warm", bytes(8192))
            sync(device)
            before = (q.dispatches, q.sharded_dispatches,
                      sum(_wrappers()[k].launches for k in kernels))
            await asyncio.gather(*(client.put(pool, f"o{i}", b)
                                   for i, b in enumerate(blobs)))
            sync(device)
            dispatches = q.dispatches - before[0]
            sharded = q.sharded_dispatches - before[1]
            launches = sum(_wrappers()[k].launches
                           for k in kernels) - before[2]
            got = [bytes(await client.get(pool, f"o{i}"))
                   for i in range(len(blobs))]
            return dispatches, sharded, launches, got
        finally:
            await client.stop()
            await cluster.stop()

    try:
        dispatches, sharded, launches, got = asyncio.run(
            asyncio.wait_for(go(), 300))
    finally:
        if osdmod._BATCH_QUEUE is not None:
            osdmod._BATCH_QUEUE.close()
        osdmod._BATCH_QUEUE = osdmod._PLANAR_STORE = None
    check(0 < dispatches < len(blobs), f"mesh cluster: {dispatches} "
          f"dispatches for {len(blobs)} concurrent puts (not coalesced)")
    check(sharded == dispatches, f"mesh cluster: only {sharded} of "
          f"{dispatches} dispatches rode the mesh")
    check(launches == mesh.n_devices * dispatches,
          f"mesh cluster: {launches} launches for {dispatches} dispatches")
    check(got == blobs, "mesh cluster: a get read back wrong")
    emit("cluster", osds=3, puts=len(blobs), object_bytes=50_000,
         dispatches=dispatches, sharded_dispatches=sharded,
         launches=launches, gets_equal=True)


def phase_mesh(device, card):
    """The batching queue on a mesh: CEPH_TPU_MESH=1 on a host with one
    card lays each dispatch over 8 shards of it.  Returns each kernel's
    launch count in this run (the mesh queues' and the cluster's)."""
    import torch

    from ceph_tpu_torch.parallel import mesh as meshmod

    def emit(step, **numbers):
        print("mesh " + json.dumps({"step": step, **numbers, "card": card}),
              flush=True)

    t_phase = time.perf_counter()
    with _env(CEPH_TPU_MESH="1"):
        mesh = meshmod.shared_mesh(device)
        check(mesh is not None, "mesh: CEPH_TPU_MESH=1 built no mesh")
        check(all(d.type == "cuda" for d in mesh.devices),
              f"mesh: a shard is off the card: {mesh.devices}")
        emit("layout", device_count=torch.cuda.device_count(),
             devices=[str(d) for d in mesh.devices],
             axes=dict(zip(mesh.axis_names, mesh.mesh.shape)),
             n_devices=mesh.n_devices)
        _zero_counts()
        lanes = _mesh_lanes(device, mesh, emit)
        _mesh_writes(device, mesh, emit)
        _mesh_cluster(device, mesh, emit)
        counts, _ = _read_counts(device, "(mesh)")
    for name in ("apply_packedbit", "xor_schedule", "apply_bytes_w8",
                 "gf2_matmul"):
        check(counts[name] > 0, f"mesh: {name} never launched")
    emit("launches", per_lane=lanes, **counts)
    print(f"mesh: phase {time.perf_counter() - t_phase:.2f}s wall")
    return counts


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
        rows = phase_kernels("cuda", card)
        counts, routes = phase_main("cuda")
        for name, n in phase_queue("cuda", card).items():
            counts[name]["queue"] = n
        store_counts, paged_rows = phase_store("cuda", card)
        for name, n in store_counts.items():
            counts[name]["store"] = n
        rows.update(paged_rows)
        for name, n in phase_osd("cuda", card).items():
            counts[name]["osd"] = n
        for name, runs in phase_codecs("cuda", card).items():
            counts[name].update(runs)
        for name, n in phase_clients("cuda", card).items():
            counts[name]["clients"] = n
        for name, n in phase_services("cuda", card).items():
            counts[name]["services"] = n
        for name, n in phase_tools("cuda", card).items():
            counts[name]["tools"] = n
        for name, n in phase_wire("cuda", card).items():
            counts[name]["wire"] = n
        for name, n in phase_mesh("cuda", card).items():
            counts[name]["mesh"] = n
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
                        ("groups", "steps", "warps_per_sm", "words",
                         "ms_turns", "scattered_ms", "composition_ms",
                         "copy_ms")
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
