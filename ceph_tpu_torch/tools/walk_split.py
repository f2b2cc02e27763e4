"""Split the packed-bit kernels' time into phases on the card, and dump
their SASS.

    python -m ceph_tpu_torch.tools.walk_split [--out DIR]

It copies ``ops/csrc/packedbit.cu`` into the build directory,
inserts ``clock64()`` stamps at the phase boundaries named in STAMPS (lane 0
of every warp writes its SM's cycle count to a device buffer), builds that
copy with the same flags as the library, and runs it through the normal
wrappers at the main path's shapes: K4 ``apply_packedbit`` of the
reed_sol_van k=8 m=3 encode on [8, 524288] bytes, and K3 ``xor_schedule``
of the cauchy_good k=8 m=3 encode and 3-erasure decode on [64, 65536]
packet rows.  The committed kernels are not touched.  For each phase it
prints the median, 90th percentile and maximum over warps in SM cycles,
and, for the walk, cycles a step of the warp's own sub-program.  The
instrumented copy is also timed with CUDA events (L2 flushed) beside the
library's own kernel, so the stamps' cost shows.  ``cuobjdump -sass`` of
the library goes to DIR (default ``ceph_tpu_torch/_build/walk_split``).
Where the kernels split the program's rows over warps, a "sweep" line for
each number of groups times K4 and K3 at those shapes (K3 on its 16- and
4-byte elements, K4 with 1 and 2 plane words a lane), each checked against
its plain version.

The patterns in STAMPS also match the one-warp kernels of commit 154a6d9:
copied into a checkout of that commit, the script splits its kernels the
same way.  It runs on the card only; without one it exits 2.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

#: kernel -> [(stamp, "before" | "after", regex)]: a stamp goes before or
#: after the first match of the regex inside that kernel's body, in order.
#: The patterns match both the one-warp kernels of commit 154a6d9 and the
#: grouped ones after them.  In the grouped K4, "load" ends when the warp's
#: own items have landed and "to_words" includes the wait at the barrier
#: for the other warps; stamp 3 goes before the barrier ahead of the
#: packing, or before the early return where there is none.
STAMPS = {
    "apply_packedbit_kernel": [
        (0, "before", r"// The warps share the \(row|stage_program\("),
        (1, "after",
         r"cp_async_wait_all\(\);\s*__syncthreads\(\);|__syncwarp\(\);"),
        (2, "before", r"V\* mine = |const long long w = "),
        (3, "before", r"__syncthreads\(\);\s*// a chunk|if \(!live\) return;"),
        (4, "end", None),
    ],
    "xor_schedule_kernel": [
        (0, "before",
         r"#pragma unroll 4\s*for \(int r = group|stage_program\("),
        (1, "after", r"cp_async_wait_all\(\);\s*__syncthreads\(\);"),
        (2, "end", None),
    ],
}
PHASES = {"apply_packedbit_kernel": ("load", "to_words", "walk", "pack"),
          "xor_schedule_kernel": ("load", "walk")}
WALK = {"apply_packedbit_kernel": 2, "xor_schedule_kernel": 1}
SLOTS = 8  # stamps a warp

PRELUDE = r"""
__device__ unsigned long long* ctt_stamps;
#define CTT_STAMP(i)                                                        \
  do {                                                                      \
    if ((threadIdx.x & 31) == 0)                                            \
      ctt_stamps[((unsigned long long)blockIdx.x * (blockDim.x >> 5) +      \
                  (threadIdx.x >> 5)) * 8 + (i)] = clock64();               \
  } while (0)
"""
EPILOGUE = r"""
extern "C" int ctt_set_stamps(void* p) {
  return (int)cudaMemcpyToSymbol(ctt_stamps, &p, sizeof(p));
}
"""


def _body(src: str, kernel: str):
    """(start, end) of the body of `kernel`'s definition: from after its
    opening brace to its closing one."""
    m = re.search(r"__global__[^{;]*\b" + kernel + r"\b[^{;]*\{", src)
    if m is None:
        raise SystemExit(f"walk_split: kernel {kernel} not found")
    depth, i = 1, m.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        i += 1
    return m.end(), i - 1


def instrument(src: str) -> str:
    """The source with CTT_STAMP(i) at each place STAMPS names."""
    for kernel, marks in STAMPS.items():
        start, end = _body(src, kernel)
        body, inserts, pos = src[start:end], [], 0
        for i, where, pattern in marks:
            if where == "end":
                inserts.append((len(body), f"  CTT_STAMP({i});\n"))
                continue
            m = re.compile(pattern).search(body, pos)
            if m is None:
                raise SystemExit(
                    f"walk_split: {kernel}: no match for {pattern}")
            at = m.start() if where == "before" else m.end()
            inserts.append((at, f"CTT_STAMP({i});"
                            + ("\n  " if where == "before" else "")))
            pos = m.end()
        for at, text in sorted(inserts, reverse=True):
            body = body[:at] + text + body[at:]
        src = src[:start] + body + src[end:]
    include = '#include "packedbit.cuh"'
    head = src.index(include) + len(include)
    return src[:head] + "\n" + PRELUDE + src[head:] + EPILOGUE


def build_copy(source: str) -> str:
    from ceph_tpu_torch.ops import build

    with open(source) as f:
        text = instrument(f.read())
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cu = os.path.join(build.BUILD_DIR, "packedbit_stamped.cu")
    so = os.path.join(build.BUILD_DIR, "libpackedbit_stamped.so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR,
                    "-o", so, cu], check=True, capture_output=True, text=True)
    return so


def dump_sass(out_dir: str) -> None:
    from ceph_tpu_torch.ops import build

    lib = build.library_path("packedbit")
    build.load("packedbit")
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "packedbit.sass")
    with open(path, "w") as f:
        f.write(sass.stdout or sass.stderr)
    print(f"sass: {path} ({len(sass.stdout.splitlines())} lines)")


def sweep(pb, timed, data, rows, matrices) -> None:
    """K4 and K3 at the main path's shapes for each number of groups and, for
    K3, each wide element: one "sweep" line each, CUDA-event medians (ms)."""
    import torch

    from ceph_tpu_torch.ops.gf2 import xor_schedule_program

    planes = torch.from_numpy(np.random.default_rng(8).integers(
        -2**31, 2**31 - 1, (88, 16384), dtype=np.int32)).cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for groups in (1, 2, 3, 4, 6, 8):
        progs = {}
        for name, bm in matrices.items():
            ops, outs, _ = xor_schedule_program(bm, cse=True)
            progs[name] = pb.Program(ops, outs, bm.shape[1], groups=groups)
        prog = progs["rs_encode"]
        want = pb.apply_packedbit_plain(prog, data)
        line = {"groups": groups,
                "steps": {n: p.steps for n, p in progs.items()}}
        for words in pb.K4_WORDS:
            assert torch.equal(pb.apply_packedbit(prog, data, words=words),
                               want)
            line[f"apply_packedbit w{words}"] = timed(
                lambda: pb.apply_packedbit(prog, data, words=words))
        for name, x in (("cauchy_good", rows), ("cauchy_decode3", rows),
                        ("rs_decode3_resident", planes)):
            p = progs[name]
            want = pb.xor_schedule_plain(p, x)
            for route in ("v16", "v4"):
                assert torch.equal(pb.xor_schedule(p, x, route), want)
                line[f"{name} {route}"] = timed(
                    lambda: pb.xor_schedule(p, x, route))
                line[f"{name} {route} warps_per_sm"] = pb.warps_per_sm(
                    p, x.shape[1] * x.element_size() // pb._VEC[route], sms)
        print("sweep " + json.dumps(line))


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(
        ROOT, "ceph_tpu_torch", "_build", "walk_split"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("walk_split: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from ceph_tpu_torch.ec.matrices import (cauchy_good_matrix,
                                            invert_bitmatrix,
                                            matrix_to_bitmatrix,
                                            vandermonde_coding_matrix)
    from ceph_tpu_torch.ec.plugins.jerasure import JerasurePlugin
    from ceph_tpu_torch.ops import build
    from ceph_tpu_torch.ops import cuda_packedbit as pb
    from ceph_tpu_torch.ops.gf2 import xor_schedule_program

    dump_sass(args.out)
    stamped = ctypes.CDLL(build_copy(
        os.path.join(build.CSRC_DIR, "packedbit.cu")))
    stamped.ctt_set_stamps.argtypes = [ctypes.c_void_p]
    real_load = build.load

    def program(bm):
        ops, outs, _ = xor_schedule_program(bm, cse=True)
        return pb.Program(ops, outs, bm.shape[1])

    cauchy = matrix_to_bitmatrix(cauchy_good_matrix(8, 3, 8), 8)
    full = np.vstack([np.eye(64, dtype=np.uint8), cauchy])
    chosen = [c for c in range(11) if c not in (1, 5, 9)][:8]
    rs = JerasurePlugin().factory({"plugin": "jerasure", "k": "8", "m": "3",
                                   "technique": "reed_sol_van"})
    kept, inv = rs.decode_selection({0, 4, 7}, set(range(11)) - {0, 4, 7})
    resident = np.zeros((24, 88), dtype=np.uint8)
    for i, c in enumerate(kept):  # the decode over data ‖ parity planes
        resident[:, c * 8:(c + 1) * 8] = matrix_to_bitmatrix(
            inv[[0, 4, 7]], 8)[:, i * 8:(i + 1) * 8]
    matrices = {
        "rs_encode": matrix_to_bitmatrix(
            vandermonde_coding_matrix(8, 3, 8), 8),
        "cauchy_good": cauchy,
        "cauchy_decode3": invert_bitmatrix(
            np.vstack([full[c * 8:(c + 1) * 8] for c in chosen])),
        "rs_decode3_resident": resident,
    }
    progs = {name: program(bm) for name, bm in matrices.items()}
    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.integers(0, 256, (8, 1 << 19),
                                         dtype=np.uint8)).cuda()
    rows = torch.from_numpy(rng.integers(0, 256, (64, 1 << 16),
                                         dtype=np.uint8)).cuda()
    cases = [("apply_packedbit_kernel", "rs_encode [24,64]x[8,524288]",
              progs["rs_encode"], lambda prog: pb.apply_packedbit(prog, data))]
    for name in ("cauchy_good", "cauchy_decode3"):
        prog = progs[name]
        cases.append(("xor_schedule_kernel",
                      f"{name} [{prog.R},64]x[64,65536] u8", prog,
                      lambda prog: pb.xor_schedule(prog, rows)))
    stamps = torch.zeros(1 << 22, dtype=torch.int64, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn, reps=20):
        fn()
        out = []
        for _ in range(reps):
            flush.zero_()
            torch.cuda._sleep(2_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    for kernel, label, prog, fn in cases:
        build.load = real_load
        pb._lib.cache_clear()
        plain_ms = timed(lambda: fn(prog))
        build.load = (lambda name: stamped if name == "packedbit"
                      else real_load(name))
        pb._lib.cache_clear()
        assert stamped.ctt_set_stamps(stamps.data_ptr()) == 0
        stamped_ms = timed(lambda: fn(prog))
        stamps.zero_()
        flush.zero_()
        torch.cuda.synchronize()
        fn(prog)
        torch.cuda.synchronize()
        # one row a warp, warps of a block together: warp g walks group g
        groups = getattr(prog, "groups", 1)
        lengths = np.diff(getattr(prog, "offsets", [0, len(prog.code)]))
        n_marks = len(STAMPS[kernel])
        s = stamps.view(-1, SLOTS).cpu().numpy()[:, :n_marks]
        blocks = len(s) // groups
        s = s[:blocks * groups].reshape(blocks, groups, n_marks)
        s = s[(s != 0).all(axis=(1, 2))]
        d = np.diff(s, axis=2)
        phases = {}
        for j, ph in enumerate(PHASES[kernel]):
            col = d[:, :, j].ravel()
            phases[ph] = {"median": float(np.median(col)),
                          "p90": float(np.percentile(col, 90)),
                          "max": int(col.max())}
        walk = d[:, :, WALK[kernel]]
        print("split " + json.dumps({
            "kernel": kernel, "shape": label, "groups": groups,
            "blocks": int(len(s)), "warps": int(s.shape[0] * groups),
            "steps_by_group": lengths.tolist(), "cycles": phases,
            "walk_cycles_a_step_median": float(np.median(walk / lengths)),
            "block_span_cycles_median": float(np.median(
                s[:, :, -1].max(axis=1) - s[:, :, 0].min(axis=1))),
            "ms_library": plain_ms, "ms_stamped": stamped_ms}))
    build.load = real_load
    pb._lib.cache_clear()
    if hasattr(pb, "GROUPS"):
        sweep(pb, timed, data, rows, matrices)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
                          "clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(f"card: {out.stdout.strip()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
