"""The packed-bit XOR-schedule kernels on Hopper: programs, wrappers, plain
versions, launch counts.

Counterpart of the packed-bit lane of ceph_tpu/ops/gf2.py, whose functions XLA
fuses into one loop per compiled schedule.  Here each is one CUDA C++ kernel
in ``csrc/packedbit.cu`` (design and bound are noted there), and the schedule
is an operand, so one build serves every matrix:

* ``xor_schedule``    (K3) <- ``gf2_xor_packed``: an XOR program over the
  first C rows of int32 plane words or uint8 packet rows -> R rows of the
  same dtype, on a route named by its element width (``v16``, ``v4``,
  ``b1``: 16, 4 or 1 bytes a thread, as the addresses and the row pitch
  allow);
* ``apply_packedbit`` (K4) <- ``gf2_apply_packedbit`` and, with
  ``resident=True``, ``gf2_encode_packedbit_resident``: [k, B] uint8 chunks
  -> plane words -> program -> [out, B] uint8 in one launch;
* ``to_packedbit``    (K5) and ``from_packedbit`` (K6): the two transposes.

Plane words are ``torch.int32`` tensors carrying the u32 bit pattern (PyTorch
on the CPU has no shifts on uint32): [rows, ceil(B/32)], bit b of word i is
column 32i+b, and plane row j*8+x is bit x of chunk j's bytes.  Pad bits of
the last word are zero; only real columns are written back.

A ``Program`` is encoded once per matrix (ops/gf2.py caches it in the
schedule LRU) into int16 instructions, with temps in slots reused by
liveness; its copy on each device it has run on stays in it, so a hit
uploads nothing.  Each wrapper checks its operands and raises ValueError for
what the kernel does not take, with the limit.  On a CUDA tensor it launches
on PyTorch's current stream and counts the launch (``launches``, and
``routes`` where it has routes); a launch error raises, nothing retries
elsewhere.  On a CPU tensor it returns the plain PyTorch version, which
replays the schedule with tensor XOR.
"""

from __future__ import annotations

import ctypes
import functools
import heapq
import threading
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

from ceph_tpu_torch.ops import build

#: step flags (csrc/packedbit.cuh): the step starts or ends an output row
FIRST, LAST = 1, 2

#: shared memory a block may use on an H100 (csrc/packedbit.cuh)
MAX_SMEM = 232448
#: value indices travel as int16, output rows in 13 bits beside the flags
MAX_INDEX = 32767
MAX_ROWS = 8191
#: threads a block of K5 and K6
TRANSPOSE_THREADS = 128

XOR_ROUTES = ("v16", "v4", "b1")
APPLY_ROUTES = ("apply", "resident")
_VEC = {"v16": 16, "v4": 4, "b1": 1}


def schedule_steps(ops: Sequence[Tuple[int, int]],
                   outs: Sequence[List[int]], C: int) -> List[Tuple]:
    """The order the kernel walks (ops, outs) in, as steps over terms: each
    step XORs two terms (None reads zero) into a temp, or into the output
    row being accumulated.

    The kernel loads a step's operands before the previous step has stored
    its result, so no step may read the temp the step before it wrote.  Items
    are emitted greedily: first any ready output row (one whose temps are all
    computed; its terms in ascending order, two a step, so the newest temp
    comes last) whose first step does not read the temp just written, else
    the next temp if it does not, else a step that does nothing.  Output rows
    are emitted as soon as they are ready, so that temps die early.
    Returns steps ("t", i, a, b), ("o", row, a, b, first, last), ("nop",)."""
    ready: List[List[int]] = [[] for _ in range(len(ops) + 1)]
    for r, terms in enumerate(outs):
        ready[max((t - C + 1 for t in terms if t >= C), default=0)].append(r)
    row_steps = []
    for terms in outs:
        pairs = [tuple(terms[i:i + 2]) + (None,) * (i + 2 > len(terms))
                 for i in range(0, len(terms), 2)] or [(None, None)]
        row_steps.append(pairs)
    pending = list(ready[0])
    steps: List[Tuple] = []
    i, last = 0, None
    while i < len(ops) or pending:
        r = next((r for r in pending
                  if last is None or last not in row_steps[r][0]), None)
        if r is not None:
            pending.remove(r)
            n = len(row_steps[r])
            steps += [("o", r, a, b, j == 0, j == n - 1)
                      for j, (a, b) in enumerate(row_steps[r])]
            last = None
        elif i < len(ops) and (last is None or last not in ops[i]):
            steps.append(("t", i) + tuple(ops[i]))
            pending += ready[i + 1]
            last, i = C + i, i + 1
        else:
            steps.append(("nop",))
            last = None
    return steps


def encode_program(ops: Sequence[Tuple[int, int]], outs: Sequence[List[int]],
                   C: int) -> Tuple[np.ndarray, int]:
    """(ops, outs) of xor_schedule_program over C inputs -> (int16 [n, 4]
    steps (a, b, d, flags | row << 2), number of temp slots).

    Each step stores value[a] ^ value[b] into value[d], and also XORs it into
    the accumulator (FIRST: starts it) and stores that as output row `row`
    (LAST).  Value index v < C is input row v, C + s is temp slot s, then
    come ZERO (always zero) and DUMMY (written, never read): an output step
    writes DUMMY, an odd term or an empty row reads ZERO.  Steps come in
    schedule_steps' order; a temp's slot is freed after its last read
    (before that step's own result is allocated, which may reuse it) and
    the lowest free slot is taken first."""
    steps = schedule_steps(ops, outs, C)
    last: Dict[int, int] = {}
    for pos, step in enumerate(steps):
        for t in (step[2:4] if step[0] != "nop" else ()):
            if t is not None and t >= C:
                last[t] = pos
    free: List[int] = []
    slot: Dict[int, int] = {}
    n_slots = 0
    coded = []
    for pos, step in enumerate(steps):
        if step[0] == "nop":
            coded.append((None, None, "dummy", 0))
            continue
        reads = [t if t is None or t < C else ("slot", slot[t])
                 for t in step[2:4]]
        for t in set(step[2:4]):
            if t is not None and t >= C and last[t] == pos:
                heapq.heappush(free, slot[t])
        if step[0] == "o":
            _, row, _, _, first, is_last = step
            coded.append((*reads, "dummy",
                          (FIRST if first else 0) | (LAST if is_last else 0)
                          | row << 2))
            continue
        s = heapq.heappop(free) if free else n_slots
        n_slots = max(n_slots, s + 1)
        slot[C + step[1]] = s
        coded.append((*reads, ("slot", s), 0))
        if C + step[1] not in last:  # never read: free at once
            heapq.heappush(free, s)
    zero, dummy = C + n_slots, C + n_slots + 1
    if dummy > MAX_INDEX or len(outs) > MAX_ROWS:
        raise ValueError(f"program of {C} inputs, {n_slots} slots and "
                         f"{len(outs)} outputs exceeds the limits of its "
                         f"encoding ({MAX_INDEX} values, {MAX_ROWS} rows)")

    def index(v) -> int:
        if v is None:
            return zero
        if v == "dummy":
            return dummy
        return C + v[1] if isinstance(v, tuple) else v

    code = [(index(a), index(b), index(d), meta) for a, b, d, meta in coded]
    return np.asarray(code, dtype=np.int16).reshape(-1, 4), n_slots


class Program:
    """A compiled XOR schedule: (ops, outs) over C inputs and R outputs, its
    encoded instructions, and their copy on each device it has run on."""

    def __init__(self, ops, outs, C: int) -> None:
        self.ops = [tuple(p) for p in ops]
        self.outs = [list(o) for o in outs]
        self.C, self.R = C, len(outs)
        self.code, self.n_slots = encode_program(self.ops, self.outs, C)
        self.n_vals = C + self.n_slots + 2  # and ZERO, DUMMY
        self._on: Dict[torch.device, torch.Tensor] = {}
        self._lock = threading.Lock()

    def on(self, device: torch.device) -> torch.Tensor:
        with self._lock:
            code = self._on.get(device)
            if code is None:
                code = self._on[device] = torch.from_numpy(self.code).to(device)
            return code


# ------------------------------------------------------------ plain versions --

def xor_schedule_plain(prog: Program, rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of xor_schedule: replay (ops, outs) with tensor
    XOR over rows[:C], temps numbered from C; an empty row is zeros."""
    vals = [rows[i] for i in range(prog.C)]
    for a, b in prog.ops:
        vals.append(vals[a] ^ vals[b])
    out = torch.zeros((prog.R, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for r, terms in enumerate(prog.outs):
        if terms:
            acc = vals[terms[0]]
            for t in terms[1:]:
                acc = acc ^ vals[t]
            out[r] = acc
    return out


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def to_packedbit_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain version of to_packedbit: [n, B] uint8 -> [n*8, ceil(B/32)] int32
    words.  Each word is built as its four bytes in uint8 (byte q holds
    columns 32i+8q .. 32i+8q+7) and viewed as int32, little-endian."""
    n, B = data.shape
    W = -(-B // 32)
    padded = torch.zeros((n, W * 32), dtype=torch.uint8, device=data.device)
    padded[:, :B] = data
    s = _shifts(data.device)
    bits = ((padded[:, None, :] >> s[None, :, None]) & 1).reshape(n * 8, W, 4, 8)
    byte = torch.zeros((n * 8, W, 4), dtype=torch.uint8, device=data.device)
    for b in range(8):
        byte |= bits[..., b] << b
    return byte.view(torch.int32).reshape(n * 8, W)


def from_packedbit_plain(planes: torch.Tensor, out_rows: int) -> torch.Tensor:
    """Plain version of from_packedbit: [out_rows*8, W] int32 words ->
    [out_rows, W*32] uint8 (bit x of byte c of row o is bit c%32 of word
    c//32 of plane o*8+x), through the words' bytes as uint8."""
    R8, W = planes.shape
    by = planes.contiguous().view(torch.uint8).reshape(R8, W * 4)
    s = _shifts(planes.device)
    bits = ((by[:, :, None] >> s[None, None, :]) & 1).reshape(
        out_rows, 8, W * 32)
    out = torch.zeros((out_rows, W * 32), dtype=torch.uint8,
                      device=planes.device)
    for x in range(8):
        out |= bits[:, x] << x
    return out


def apply_packedbit_plain(prog: Program, data: torch.Tensor,
                          resident: bool = False):
    """Plain version of apply_packedbit: to_packedbit, the schedule,
    from_packedbit, trimmed to B; with resident, also the data ‖ parity
    plane words."""
    B = data.shape[1]
    planes = to_packedbit_plain(data)
    pouts = xor_schedule_plain(prog, planes)
    out = from_packedbit_plain(pouts, prog.R // 8)[:, :B].contiguous()
    if resident:
        return out, torch.cat([planes, pouts], dim=0)
    return out


# ------------------------------------------------------------------ kernels --

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("packedbit")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ctt_xor_schedule.argtypes = [p, i, i, i, p, p, ll, i, i, p]
    lib.ctt_apply_packedbit.argtypes = [p, i, i, i, i, p, ll, p, p, i, p]
    lib.ctt_to_packedbit.argtypes = [p, i, ll, p, i, p]
    lib.ctt_from_packedbit.argtypes = [p, i, ll, p, i, p]
    for fn in (lib.ctt_xor_schedule, lib.ctt_apply_packedbit,
               lib.ctt_to_packedbit, lib.ctt_from_packedbit):
        fn.restype = i
    lib.ctt_pb_error_string.argtypes = [i]
    lib.ctt_pb_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().ctt_pb_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _prog_bytes(prog: Program) -> int:
    return (len(prog.code) * 8 + 15) // 16 * 16


def xor_schedule_smem(prog: Program, threads: int, vec: int) -> int:
    """Dynamic shared memory of a K3 block (ctt_xor_schedule's formula)."""
    return _prog_bytes(prog) + prog.n_vals * threads * vec


def apply_packedbit_smem(prog: Program, threads: int) -> int:
    """Dynamic shared memory of a K4 block (ctt_apply_packedbit's formula):
    program, input and temp words, and the byte tile, whose room the output
    words reuse."""
    return (_prog_bytes(prog) + prog.n_vals * threads * 4
            + max(4 * prog.C, 4 * prog.R) * threads)


def block_threads(blocks, smem, sms: int) -> Union[int, None]:
    """Threads a block: 128, halved (to 32 at least) while the grid would be
    under two blocks an SM, then while the block's shared memory exceeds
    MAX_SMEM; None if 32 threads still do not fit.  `blocks(T)` and
    `smem(T)` give the grid and the block's bytes for T threads."""
    T = 128
    while T > 32 and blocks(T) < 2 * sms:
        T //= 2
    while T > 32 and smem(T) > MAX_SMEM:
        T //= 2
    return T if smem(T) <= MAX_SMEM else None


def xor_schedule_route(row_bytes: int, in_addr: int, out_addr: int) -> str:
    """The widest element a K3 thread can own: 16 bytes where the row pitch
    and both addresses are multiples of 16, else 4, else 1."""
    for route in ("v16", "v4"):
        vec = _VEC[route]
        if all(n % vec == 0 for n in (row_bytes, in_addr, out_addr)):
            return route
    return "b1"


def _check_program(name: str, prog: Program) -> None:
    _check(prog.R >= 1 and prog.C >= 1, f"{name}: empty program "
           f"[{prog.R}, {prog.C}]")


def _check_device(name: str, x: torch.Tensor) -> None:
    _check(x.device.type in ("cpu", "cuda"), f"{name}: device {x.device}")
    _check(x.dim() == 2 and x.is_contiguous(),
           f"{name}: operand must be 2-D and contiguous, got "
           f"{tuple(x.shape)}")


def xor_schedule(prog: Program, rows: torch.Tensor) -> torch.Tensor:
    """The program over the first C rows of `rows` ([>= C, N] int32 plane
    words or uint8 packet rows) -> [R, N] of the same dtype.  Rows beyond C
    are ignored."""
    name = "xor_schedule"
    _check_program(name, prog)
    _check_device(name, rows)
    _check(rows.dtype in (torch.int32, torch.uint8),
           f"{name}: rows must be int32 or uint8, got {rows.dtype}")
    _check(rows.shape[0] >= prog.C, f"{name}: {rows.shape[0]} rows for a "
           f"program of {prog.C} inputs")
    if rows.device.type == "cpu":
        return xor_schedule_plain(prog, rows)
    out = torch.empty((prog.R, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    row_bytes = rows.shape[1] * rows.element_size()
    if row_bytes == 0:
        return out
    route = xor_schedule_route(row_bytes, rows.data_ptr(), out.data_ptr())
    sms = _sm_count(rows.device.index)
    for r in XOR_ROUTES[XOR_ROUTES.index(route):]:
        vec = _VEC[r]
        E = row_bytes // vec
        T = block_threads(lambda t: -(-E // t),
                          lambda t: xor_schedule_smem(prog, t, vec), sms)
        if T is not None:
            break
    else:
        raise ValueError(
            f"{name}: a program of {len(prog.code)} instructions and "
            f"{prog.n_vals} values needs {xor_schedule_smem(prog, 32, 1)} "
            f"bytes of shared memory at 32 threads, over {MAX_SMEM}")
    with torch.cuda.device(rows.device):
        rc = _lib().ctt_xor_schedule(
            prog.on(rows.device).data_ptr(), len(prog.code), prog.C,
            prog.n_vals, rows.data_ptr(), out.data_ptr(), row_bytes, vec, T,
            _stream(rows.device))
    _raise_on(rc, name)
    xor_schedule.launches += 1
    xor_schedule.routes[r] += 1
    return out


def apply_packedbit(prog: Program, data: torch.Tensor, resident: bool = False):
    """[out*8, k*8] program applied to [k, B] uint8 chunks (w=8 byte layout)
    -> [out, B] uint8; with resident, (that, the [(k+out)*8, ceil(B/32)]
    int32 data ‖ parity plane words)."""
    name = "apply_packedbit"
    _check_program(name, prog)
    _check_device(name, data)
    _check(data.dtype == torch.uint8, f"{name}: data must be uint8, got "
           f"{data.dtype}")
    k, B = data.shape
    _check(prog.C == k * 8 and prog.R % 8 == 0,
           f"{name}: a [{prog.R}, {prog.C}] program for {k} chunks")
    _check(B >= 1, f"{name}: empty data")
    if data.device.type == "cpu":
        return apply_packedbit_plain(prog, data, resident)
    out_rows, W = prog.R // 8, -(-B // 32)
    T = block_threads(lambda t: -(-W // t),
                      lambda t: apply_packedbit_smem(prog, t),
                      _sm_count(data.device.index))
    _check(T is not None,
           f"{name}: a program of {len(prog.code)} instructions and "
           f"{prog.n_vals} values needs {apply_packedbit_smem(prog, 32)} "
           f"bytes of shared memory at 32 threads, over {MAX_SMEM}")
    out = torch.empty((out_rows, B), dtype=torch.uint8, device=data.device)
    planes = (torch.empty((k * 8 + prog.R, W), dtype=torch.int32,
                          device=data.device) if resident else None)
    with torch.cuda.device(data.device):
        rc = _lib().ctt_apply_packedbit(
            prog.on(data.device).data_ptr(), len(prog.code), k, out_rows,
            prog.n_vals, data.data_ptr(), B, out.data_ptr(),
            planes.data_ptr() if resident else None, T,
            _stream(data.device))
    _raise_on(rc, name)
    apply_packedbit.launches += 1
    apply_packedbit.routes["resident" if resident else "apply"] += 1
    return (out, planes) if resident else out


def to_packedbit(data: torch.Tensor) -> torch.Tensor:
    """[n, B] uint8 -> [n*8, ceil(B/32)] int32 plane words, pad bits zero."""
    name = "to_packedbit"
    _check_device(name, data)
    _check(data.dtype == torch.uint8, f"{name}: data must be uint8, got "
           f"{data.dtype}")
    n, B = data.shape
    _check(1 <= n <= 65535 and B >= 1, f"{name}: shape {tuple(data.shape)} "
           "(1..65535 rows, B >= 1)")
    if data.device.type == "cpu":
        return to_packedbit_plain(data)
    planes = torch.empty((n * 8, -(-B // 32)), dtype=torch.int32,
                         device=data.device)
    with torch.cuda.device(data.device):
        rc = _lib().ctt_to_packedbit(data.data_ptr(), n, B, planes.data_ptr(),
                                     TRANSPOSE_THREADS, _stream(data.device))
    _raise_on(rc, name)
    to_packedbit.launches += 1
    return planes


def from_packedbit(planes: torch.Tensor, out_rows: int) -> torch.Tensor:
    """[out_rows*8, W] int32 plane words -> [out_rows, W*32] uint8."""
    name = "from_packedbit"
    _check_device(name, planes)
    _check(planes.dtype == torch.int32, f"{name}: planes must be int32, got "
           f"{planes.dtype}")
    R8, W = planes.shape
    _check(1 <= out_rows <= 65535 and R8 == out_rows * 8 and W >= 1,
           f"{name}: {tuple(planes.shape)} planes for {out_rows} rows")
    if planes.device.type == "cpu":
        return from_packedbit_plain(planes, out_rows)
    out = torch.empty((out_rows, W * 32), dtype=torch.uint8,
                      device=planes.device)
    with torch.cuda.device(planes.device):
        rc = _lib().ctt_from_packedbit(planes.data_ptr(), out_rows, W,
                                       out.data_ptr(), TRANSPOSE_THREADS,
                                       _stream(planes.device))
    _raise_on(rc, name)
    from_packedbit.launches += 1
    return out


xor_schedule.launches = 0
xor_schedule.routes = dict.fromkeys(XOR_ROUTES, 0)
apply_packedbit.launches = 0
apply_packedbit.routes = dict.fromkeys(APPLY_ROUTES, 0)
to_packedbit.launches = 0
from_packedbit.launches = 0
