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
            events.
3. main     launch counts set to 0, then the port's entry points: the
            benchmark CLI (plugin=cuda reed_sol_van k=8 m=3, 4 MiB objects,
            encode, then decode with 3 random erasures; the CLI verifies
            recovered content), 4 MiB objects under plugin=cuda against the
            port's CPU plugin=jerasure (reed_sol_van and cauchy_good k=8 m=3),
            and the archived plugin=tpu corpus replayed under plugin=cuda.
            Every kernel must have launched in this phase, every
            apply_bytes_w8 launch must have taken the xor route and every
            gf2_matmul launch the mma route.
4. split    host prepare / host->device / kernel call / device->host of
            one 4 MiB encode (the codec API takes host bytes), and the
            device's busy share over back-to-back encodes from torch.profiler.
5. report   the card, one {"kernels": [...]} line, and the result line.
"""

from __future__ import annotations

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
# the chunks a k=8 m=3 packet-layout decode reads when LOST are lost
DECODE_CHOSEN = tuple(c for c in range(11) if c not in LOST)[:8]

# H100 SXM data-sheet peaks (dense): HBM bytes/s and int8 tensor ops/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1.979e15

KERNEL_META = {
    "apply_bytes_w8": ("ceph_tpu_torch/ops/csrc/gf2.cu",
                       "ceph_tpu/ops/pallas_gf2.py:57"),
    "gf2_matmul": ("ceph_tpu_torch/ops/csrc/gf2.cu",
                   "ceph_tpu/ops/pallas_gf2.py:93"),
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
    return {
        "rs_encode": matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 8), 8),
        "rs_decode3": matrix_to_bitmatrix(inv[[0, 4, 7]], 8),
        "cauchy_good": cauchy,
        "cauchy_decode3": invert_bitmatrix(np.vstack(
            [full[c * 8:(c + 1) * 8] for c in DECODE_CHOSEN])),
        "rs_w16": matrix_to_bitmatrix(vandermonde_coding_matrix(8, 3, 16), 16),
    }


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
    return rows


# ---------------------------------------------------------------- phase 3 --

def _run_cli(argv):
    from ceph_tpu_torch.tools import benchmark

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = benchmark.main(argv)
    text = out.getvalue().strip()
    check(rc == 0, f"benchmark {' '.join(argv)} exited {rc}")
    seconds, kb = text.split("\t")
    gbps = int(kb) * 1024 / float(seconds) / 1e9
    print(f"cli {argv[argv.index('--workload') + 1]}: {text!r} "
          f"-> {gbps:.3f} GB/s of object data")


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


def phase_main(device):
    """The port's main path; returns the kernels' launch counts in it."""
    from ceph_tpu_torch.ops import cuda_gf2

    cuda_gf2.apply_bytes_w8.launches = 0
    cuda_gf2.apply_bytes_w8.routes = dict.fromkeys(cuda_gf2.K1_ROUTES, 0)
    cuda_gf2.gf2_matmul.launches = 0
    cuda_gf2.gf2_matmul.routes = dict.fromkeys(cuda_gf2.K2_ROUTES, 0)

    base = ["--plugin", "cuda", "--device", str(device), "-P",
            "technique=reed_sol_van", "-P", "k=8", "-P", "m=3",
            "--size", str(OBJECT_SIZE), "--iterations", str(CLI_ITERATIONS)]
    _run_cli(base + ["--workload", "encode"])
    _run_cli(base + ["--workload", "decode", "--erasures", "3"])

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
    sync(device)
    counts = {"apply_bytes_w8": cuda_gf2.apply_bytes_w8.launches,
              "gf2_matmul": cuda_gf2.gf2_matmul.launches}
    routes = {"apply_bytes_w8": dict(cuda_gf2.apply_bytes_w8.routes),
              "gf2_matmul": dict(cuda_gf2.gf2_matmul.routes)}
    print(f"main path launches: {json.dumps(counts)}")
    print(f"main path routes: {json.dumps(routes)}")
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    for name, route in (("apply_bytes_w8", "xor"), ("gf2_matmul", "mma")):
        check(routes[name][route] == counts[name],
              f"{name} left the {route} route on the main path: {routes[name]}")
    return counts, routes


# ---------------------------------------------------------------- phase 4 --

def phase_split(device) -> None:
    """Where one 4 MiB reed_sol_van k=8 m=3 encode spends its time."""
    import torch

    from ceph_tpu_torch.ops.cuda_gf2 import apply_bytes_w8
    from ceph_tpu_torch.ops.gf2 import bitmatrix_to_tensor
    from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix

    codec = _codec("cuda", device, technique="reed_sol_van", k=8, m=3)
    obj = np.random.default_rng(SEED + 1).integers(
        0, 256, OBJECT_SIZE, dtype=np.uint8).tobytes()
    bm = bitmatrix_to_tensor(matrix_to_bitmatrix(codec.matrix, 8), device)
    parts = {"host_prepare_ms": [], "h2d_ms": [], "kernel_call_ms": [],
             "d2h_ms": [], "encode_total_ms": []}
    for _ in range(TIMING_REPS):
        t0 = time.perf_counter()
        chunks = codec.encode_prepare(obj, codec.get_chunk_size(len(obj)))
        t1 = time.perf_counter()
        dev = torch.from_numpy(chunks).to(device)
        sync(device)
        t2 = time.perf_counter()
        out = apply_bytes_w8(bm, dev)
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
        phase_split("cuda")
        kernels = []
        for name, (source, replaces) in KERNEL_META.items():
            row = rows[name]
            kernels.append({
                "name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": row["max_abs_err"], "match": True,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "shape": row["shape"]})
        for row in kernels:
            name = row["name"]
            row.update(path=rows[name]["path"], paths=routes[name],
                       popc_ms=rows[name + ".popc"]["ms"])
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
