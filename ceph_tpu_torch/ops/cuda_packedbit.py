"""The packed-bit XOR-schedule kernels on Hopper: programs, wrappers, plain
versions, launch counts.

Counterpart of the packed-bit lane of ceph_tpu/ops/gf2.py, whose functions XLA
fuses into one loop per compiled schedule.  Here each is one CUDA C++ kernel
in ``csrc/packedbit.cu`` (design and bound are noted there), and the schedule
is an operand, so one build serves every matrix:

* ``xor_schedule``    (K3) <- ``gf2_xor_packed``: an XOR program over the
  first C rows of int32 plane words or uint8 packet rows -> R rows of the
  same dtype, on a route named by its element width (``v16``, ``v4``,
  ``b1``: 16, 4 or 1 bytes a thread), the widest the addresses and the row
  pitch allow whose grid still puts TARGET_WARPS_PER_SM warps on each SM;
* ``apply_packedbit`` (K4) <- ``gf2_apply_packedbit`` and, with
  ``resident=True``, ``gf2_encode_packedbit_resident``: [k, B] uint8 chunks
  -> plane words -> program -> [out, B] uint8 in one launch, with two plane
  words a lane where the grid still puts TARGET_WARPS_PER_SM warps on each
  SM, else one;
* ``to_packedbit``    (K5) and ``from_packedbit`` (K6): the two transposes;
* ``to_packedbit_paged`` and ``from_packedbit_paged``: K5 and K6 through a
  paged resident's page table (ops/slab.py ``PageTable``), so that an admit
  writes its plane words straight into its pages, and a read goes from the
  pages to shard rows, or to an object's stripe-major bytes, in one pass.

Plane words are ``torch.int32`` tensors carrying the u32 bit pattern (PyTorch
on the CPU has no shifts on uint32): [rows, ceil(B/32)], bit b of word i is
column 32i+b, and plane row j*8+x is bit x of chunk j's bytes.  Pad bits of
the last word are zero; only real columns are written back.

A ``Program`` is encoded once per matrix (ops/gf2.py caches it in the
schedule LRU): its output rows split into up to GROUPS groups balanced by
cost, each group's sub-program (the temps its rows need, then its rows) in
int32 instructions with temps in slots reused by liveness.  A K3 or K4
block takes 32 columns and one warp for each group.  The program's copy on
each device and row pitch it has run with stays in it, so a hit uploads
nothing.  Each wrapper checks its operands and raises ValueError for
what the kernel does not take, with the limit.  On a CUDA tensor it launches
on PyTorch's current stream and counts the launch (``launches``, and
``routes`` where it has routes; K3 and K4 keep their last launch's shape
in ``last``); a launch error raises, nothing retries elsewhere.  On a CPU
tensor it returns the plain PyTorch version, which replays the schedule
with tensor XOR.
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
from ceph_tpu_torch.ops.slab import PageTable, gather_words, install_pages

#: step flags (csrc/packedbit.cuh): the step starts or ends an output row
FIRST, LAST = 1, 2

#: shared memory a block may use on an H100 (csrc/packedbit.cuh)
MAX_SMEM = 232448
#: output-row groups a program is split into, each walked by its own warp
#: (csrc/packedbit.cuh bounds it)
GROUPS = 6
MAX_GROUPS = 16
#: steps ahead of the one it computes that the walk loads operands for
#: (csrc/packedbit.cuh); the schedule keeps a step from reading what the
#: steps in between write
PREFETCH = 1
#: columns (elements) a block takes: one warp's worth for each group
COLS = 32
#: K3 takes its widest element, and K4 the most words a lane, whose grid
#: still puts this many warps on each SM
TARGET_WARPS_PER_SM = 2
#: plane words a K4 lane may hold
K4_WORDS = (2, 1)
#: threads a block of K5 and K6
TRANSPOSE_THREADS = 128

XOR_ROUTES = ("v16", "v4", "b1")
APPLY_ROUTES = ("apply", "resident")
_VEC = {"v16": 16, "v4": 4, "b1": 1}


def schedule_steps(ops: Sequence[Tuple[int, int]],
                   outs: Sequence[List[int]], C: int,
                   temps: Sequence[int] = None,
                   rows: Sequence[int] = None) -> List[Tuple]:
    """The order the kernel walks (ops, outs) in, as steps over terms: each
    step XORs two terms (-1 reads zero) into a temp, or into the output row
    being accumulated.  With `temps` and `rows` (a group's rows and the
    temps they need, ascending), only those.

    The kernel loads a step's operands PREFETCH steps ahead, before the
    steps in between have stored their results, so no step may read a temp
    that one of the PREFETCH steps before it wrote.  Items are emitted
    greedily: first any ready output row (one whose temps are all computed;
    its terms in ascending order, two a step, so the newest temp comes last)
    whose steps read no such temp, else the next temp if it does not, else
    a step that does nothing.  Output rows are emitted as soon as they are
    ready, so that temps die early.  Returns steps ("t", i, a, b),
    ("o", row, a, b, first, last), ("nop",)."""
    temps = range(len(ops)) if temps is None else temps
    rows = range(len(outs)) if rows is None else rows
    done_at = {C + t: j + 1 for j, t in enumerate(temps)}
    ready: List[List[int]] = [[] for _ in range(len(temps) + 1)]
    pairs = {}
    for r in rows:
        terms = outs[r]
        at = 0
        for t in terms:
            if t >= C and done_at[t] > at:
                at = done_at[t]
        ready[at].append(r)
        pairs[r] = [(terms[q], terms[q + 1] if q + 1 < len(terms) else -1)
                    for q in range(0, len(terms), 2)] or [(-1, -1)]
    pending = list(ready[0])
    steps: List[Tuple] = []
    gap = PREFETCH
    recent = [-2] * gap  # the temps the last `gap` steps wrote (-2: none)
    j, n_temps = 0, len(temps)
    while j < n_temps or pending:
        for q, r in enumerate(pending):
            # the row's step i follows its own i steps, which write no temp
            row = pairs[r]
            if all(a not in recent[i:] and b not in recent[i:]
                   for i, (a, b) in enumerate(row[:gap])):
                del pending[q]
                n = len(row) - 1
                steps += [("o", r, a, b, q == 0, q == n)
                          for q, (a, b) in enumerate(row)]
                recent = (recent + [-2] * len(row))[-gap:]
                break
        else:
            i = temps[j] if j < n_temps else None
            if i is not None and ops[i][0] not in recent \
                    and ops[i][1] not in recent:
                steps.append(("t", i) + tuple(ops[i]))
                pending += ready[j + 1]
                recent = recent[1:] + [C + i]
                j += 1
            else:
                steps.append(("nop",))
                recent = recent[1:] + [-2]
    return steps


def row_closures(ops: Sequence[Tuple[int, int]], outs: Sequence[List[int]],
                 C: int) -> List[int]:
    """For each output row, the temps it needs (its terms' temps and theirs,
    transitively), as a bit set: bit i is temp i (value C + i)."""
    clo: List[int] = []
    for a, b in ops:
        c = 1 << len(clo)
        if a >= C:
            c |= clo[a - C]
        if b >= C:
            c |= clo[b - C]
        clo.append(c)
    need = []
    for terms in outs:
        c = 0
        for t in terms:
            if t >= C:
                c |= clo[t - C]
        need.append(c)
    return need


def partition_rows(ops: Sequence[Tuple[int, int]],
                   outs: Sequence[List[int]], C: int, groups: int,
                   need: List[int] = None) -> List[List[int]]:
    """The output rows in at most `groups` non-empty groups, balanced by the
    steps each group's sub-program takes: the temps its rows need (shared
    temps count once) and its rows' own steps.  Rows go greedily, costliest
    first, to the group that keeps the longest group shortest, then adds the
    fewest steps, then has the fewest.  Rows are not cut into runs of
    neighbours: a decode's identity rows cost one step each, its parity rows
    dozens."""
    if need is None:
        need = row_closures(ops, outs, C)
    own = [max(1, (len(t) + 1) // 2) for t in outs]
    G = max(1, min(groups, len(outs)))
    temps, steps, cost = [0] * G, [0] * G, [0] * G
    rows: List[List[int]] = [[] for _ in range(G)]
    for r in sorted(range(len(outs)),
                    key=lambda r: (-need[r].bit_count() - own[r], r)):
        top = max(cost)
        first = cost.index(top)
        second = max(cost[:first] + cost[first + 1:], default=0)
        best = None
        for g in range(G):
            after = ((temps[g] | need[r]).bit_count() + steps[g] if need[r]
                     else cost[g]) + own[r]
            key = (max(after, second if g == first else top), after - cost[g],
                   cost[g])
            if best is None or key < best[0]:
                best = (key, g, after)
        _, g, cost[g] = best
        temps[g] |= need[r]
        steps[g] += own[r]
        rows[g].append(r)
    return [sorted(rs) for rs in rows if rs]


def _encode_steps(steps: List[Tuple], C: int, n_ops: int, zero: int,
                  dummy: int, base: int, code: List[int]) -> int:
    """One sub-program's steps, appended to `code` as instructions (a, b, d,
    flags | row << 2), four ints each; returns its number of slots.  Value
    index v < C is input row v, then this sub-program's temp slots from
    C + base; a term -1 reads `zero`, an output step writes `dummy`.  A
    temp's slot is freed after its last read (before that step's own result
    is allocated, which may reuse it) and the lowest free slot is taken
    first."""
    first = C + base
    # where each value is (inputs stay, temps get slots); loc[-1] is ZERO
    loc = list(range(C)) + [0] * n_ops + [zero]
    reads = [0] * (C + n_ops + 1)
    for st in steps:
        if st[0] != "nop":
            reads[st[2]] += 1
            reads[st[3]] += 1
    free: List[int] = []
    n_slots = 0
    for st in steps:
        kind = st[0]
        if kind == "nop":
            code += (zero, zero, dummy, 0)
            continue
        a, b = st[2], st[3]
        ea, eb = loc[a], loc[b]
        for t in (a, b):
            if t >= C:
                reads[t] -= 1
                if not reads[t]:
                    heapq.heappush(free, loc[t] - first)
        if kind == "o":
            code += (ea, eb, dummy, (FIRST if st[4] else 0)
                     | (LAST if st[5] else 0) | st[1] << 2)
            continue
        if free:
            slot = heapq.heappop(free)
        else:
            slot, n_slots = n_slots, n_slots + 1
        t = C + st[1]
        loc[t] = first + slot
        code += (ea, eb, first + slot, 0)
        if not reads[t]:  # never read: free at once
            heapq.heappush(free, slot)
    return n_slots


def encode_program(ops: Sequence[Tuple[int, int]], outs: Sequence[List[int]],
                   C: int, groups: int = 1):
    """(ops, outs) of xor_schedule_program over C inputs, its output rows
    split into at most `groups` groups (partition_rows) -> (int32 [n, 4]
    steps (a, b, d, flags | row << 2), int32 [G + 1] offsets of each
    group's steps, number of temp slots, each group's rows).

    Each group's sub-program holds the temps its rows need (in ops' order)
    and then its rows, in schedule_steps' order, so that no step reads a
    temp that one of the PREFETCH steps before it in its group wrote.  Each
    step stores value[a] ^ value[b] into value[d], and also XORs it into the
    accumulator (FIRST: starts it) and stores that as output row `row`
    (LAST).  Value
    index v < C is input row v; each group's temps have their own slots,
    reused by liveness within the group, numbered from C; then come ZERO
    (always zero) and DUMMY (written, never read): an output step writes
    DUMMY, an odd term or an empty row reads ZERO."""
    need = row_closures(ops, outs, C)
    parts = partition_rows(ops, outs, C, groups, need)
    code: List[int] = []
    offsets, total = [0], 0
    for rows in parts:
        mask = 0
        for r in rows:
            mask |= need[r]
        temps = [i for i, bit in enumerate(bin(mask)[:1:-1]) if bit == "1"]
        # slots are placed after encoding: ZERO and DUMMY as -1 and -2
        total += _encode_steps(schedule_steps(ops, outs, C, temps, rows),
                               C, len(ops), -1, -2, total, code)
        offsets.append(len(code) // 4)
    code = np.array(code, dtype=np.int32).reshape(-1, 4)
    vals = code[:, :3]
    vals[vals == -1] = C + total  # ZERO
    vals[vals == -2] = C + total + 1  # DUMMY
    offsets = np.array(offsets, dtype=np.int32)
    return code, offsets, total, parts


class Program:
    """A compiled XOR schedule: (ops, outs) over C inputs and R outputs, its
    output rows in `groups` groups (each walked by its own warp), its encoded
    instructions, and their copy on each device and row pitch it has run
    with."""

    def __init__(self, ops, outs, C: int, groups: int = GROUPS) -> None:
        self.ops = [tuple(p) for p in ops]
        self.outs = [list(o) for o in outs]
        self.C, self.R = C, len(outs)
        self.code, self.offsets, self.n_slots, self.rows = encode_program(
            self.ops, self.outs, C, min(groups, MAX_GROUPS))
        self.groups = len(self.rows)
        #: steps of the longest sub-program: the walk's critical path
        self.steps = int(np.diff(self.offsets).max())
        self.n_vals = C + self.n_slots + 2  # and ZERO, DUMMY
        self._on: Dict[Tuple[torch.device, int], torch.Tensor] = {}
        self._lock = threading.Lock()

    def on(self, device: torch.device, pitch: int) -> torch.Tensor:
        """The program as the kernels stage it: the groups' offsets in a
        header of whole int4 rows, the instructions with value indices times
        `pitch` (bytes of one value's row in shared memory) and -1 for
        DUMMY (a result nothing reads is not stored), and PREFETCH + 1
        steps that do nothing after the last, which the walk reads ahead."""
        with self._lock:
            code = self._on.get((device, pitch))
            if code is None:
                zero, dummy = self.n_vals - 2, self.n_vals - 1
                header = np.zeros((self.groups + 4) // 4 * 4, dtype=np.int32)
                header[:len(self.offsets)] = self.offsets
                steps = np.vstack([self.code,
                                   [[zero, zero, dummy, 0]] * (PREFETCH + 1)])
                steps[:, :3] *= pitch
                steps[steps[:, 2] == dummy * pitch, 2] = -1  # not stored
                code = self._on[(device, pitch)] = torch.from_numpy(
                    np.vstack([header.reshape(-1, 4), steps])
                    .astype(np.int32)).to(device)
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


def from_packedbit_paged_plain(table: PageTable, w0: int, row_words: int,
                               out_rows: int, L: int,
                               cs: int = 0, object_size: int = 0
                               ) -> torch.Tensor:
    """Plain version of from_packedbit_paged: slab_gather of the pages the
    rows lie in, from_packedbit_plain, the first L columns, and for an
    object read (cs > 0) the de-interleave [k, L/cs, cs] -> stripe-major,
    cut to object_size."""
    words = gather_words(table, w0, out_rows * 8 * row_words)
    rows = from_packedbit_plain(words.view(out_rows * 8, row_words),
                                out_rows)[:, :L]
    if not cs:
        return rows.contiguous()
    return (rows.reshape(out_rows, L // cs, cs).transpose(0, 1)
            .reshape(-1)[:object_size].contiguous())


def to_packedbit_paged_plain(data: torch.Tensor, table: PageTable) -> None:
    """Plain version of to_packedbit_paged: to_packedbit_plain, the words
    in a zero-filled image of the pages, then slab_install of the image."""
    words = to_packedbit_plain(data).view(-1)
    image = torch.zeros(len(table.pages) * table.page_words,
                        dtype=torch.int32, device=data.device)
    image[:words.numel()] = words
    install_pages(table, image.view(len(table.pages), table.page_words))


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
    lib.ctt_xor_schedule.argtypes = [p, i, i, i, i, p, p, ll, i, p]
    lib.ctt_apply_packedbit.argtypes = [p, i, i, i, i, i, p, ll, p, p, i, p]
    lib.ctt_to_packedbit.argtypes = [p, i, ll, p, i, p]
    lib.ctt_from_packedbit.argtypes = [p, i, ll, p, i, p]
    lib.ctt_from_packedbit_paged.argtypes = [p, i, ll, ll, ll, i, ll, ll, ll,
                                             p, i, p]
    lib.ctt_to_packedbit_paged.argtypes = [p, i, ll, p, i, ll, i, p]
    for fn in (lib.ctt_xor_schedule, lib.ctt_apply_packedbit,
               lib.ctt_to_packedbit, lib.ctt_from_packedbit,
               lib.ctt_from_packedbit_paged, lib.ctt_to_packedbit_paged):
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
    return ((prog.groups + 4) // 4 + len(prog.code) + PREFETCH + 1) * 16


def xor_schedule_smem(prog: Program, cols: int, vec: int) -> int:
    """Dynamic shared memory of a K3 block of `cols` columns of `vec`-byte
    elements (ctt_xor_schedule's formula, at cols = COLS)."""
    return _prog_bytes(prog) + prog.n_vals * cols * vec


def apply_packedbit_smem(prog: Program, cols: int) -> int:
    """Dynamic shared memory of a K4 block of `cols` word columns
    (ctt_apply_packedbit's formula, at cols = COLS times the words a lane):
    program, input and temp words, and the byte tile, whose room the output
    words reuse."""
    return (_prog_bytes(prog) + prog.n_vals * cols * 4
            + max(4 * prog.C, 4 * prog.R) * cols)


def warps_per_sm(prog: Program, columns: int, sms: int) -> float:
    """Warps a K3 or K4 launch over `columns` columns (elements, or groups of
    a lane's words) puts on each SM: one block of 32 columns has one warp
    for each of the program's groups."""
    return -(-columns // COLS) * prog.groups / sms


def apply_packedbit_words(prog: Program, W: int, sms: int) -> Union[int, None]:
    """Plane words a K4 lane holds for W word columns: two where the block
    fits in shared memory and the grid still puts TARGET_WARPS_PER_SM warps
    on each SM, else one; None if neither fits."""
    fits = [n for n in K4_WORDS
            if apply_packedbit_smem(prog, COLS * n) <= MAX_SMEM]
    for n in fits:
        if warps_per_sm(prog, -(-W // n), sms) >= TARGET_WARPS_PER_SM:
            return n
    return fits[-1] if fits else None


def xor_schedule_route(prog: Program, row_bytes: int, in_addr: int,
                       out_addr: int, sms: int) -> Union[str, None]:
    """K3's element width: the widest of v16 and v4 that the row pitch and
    both addresses allow, whose block fits in shared memory, and whose grid
    puts at least TARGET_WARPS_PER_SM warps on each SM; else the narrowest
    of them that fits (the most warps); b1 only where neither is allowed or
    fits.  None if no element width fits."""
    allowed = [r for r in XOR_ROUTES
               if all(n % _VEC[r] == 0 for n in (row_bytes, in_addr, out_addr))
               and xor_schedule_smem(prog, COLS, _VEC[r]) <= MAX_SMEM]
    wide = [r for r in allowed if r != "b1"]
    for r in wide:
        if (warps_per_sm(prog, row_bytes // _VEC[r], sms)
                >= TARGET_WARPS_PER_SM):
            return r
    return wide[-1] if wide else (allowed[-1] if allowed else None)


def _check_program(name: str, prog: Program) -> None:
    _check(prog.R >= 1 and prog.C >= 1, f"{name}: empty program "
           f"[{prog.R}, {prog.C}]")


def _check_device(name: str, x: torch.Tensor) -> None:
    _check(x.device.type in ("cpu", "cuda"), f"{name}: device {x.device}")
    _check(x.dim() == 2 and x.is_contiguous(),
           f"{name}: operand must be 2-D and contiguous, got "
           f"{tuple(x.shape)}")


def xor_schedule(prog: Program, rows: torch.Tensor,
                 route: Union[str, None] = None) -> torch.Tensor:
    """The program over the first C rows of `rows` ([>= C, N] int32 plane
    words or uint8 packet rows) -> [R, N] of the same dtype.  Rows beyond C
    are ignored.  `route` forces an element width (v16, v4 or b1) that the
    operands allow; by default xor_schedule_route picks it."""
    name = "xor_schedule"
    _check_program(name, prog)
    _check_device(name, rows)
    _check(rows.dtype in (torch.int32, torch.uint8),
           f"{name}: rows must be int32 or uint8, got {rows.dtype}")
    _check(rows.shape[0] >= prog.C, f"{name}: {rows.shape[0]} rows for a "
           f"program of {prog.C} inputs")
    _check(route is None or route in XOR_ROUTES, f"{name}: route {route}")
    if rows.device.type == "cpu":
        return xor_schedule_plain(prog, rows)
    out = torch.empty((prog.R, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    row_bytes = rows.shape[1] * rows.element_size()
    if row_bytes == 0:
        return out
    sms = _sm_count(rows.device.index)
    if route is None:
        route = xor_schedule_route(prog, row_bytes, rows.data_ptr(),
                                   out.data_ptr(), sms)
        _check(route is not None,
               f"{name}: a program of {len(prog.code)} instructions and "
               f"{prog.n_vals} values needs {xor_schedule_smem(prog, COLS, 1)}"
               f" bytes of shared memory at {COLS} one-byte columns, over "
               f"{MAX_SMEM}")
    vec = _VEC[route]
    _check(all(n % vec == 0 for n in (row_bytes, rows.data_ptr(),
                                      out.data_ptr()))
           and xor_schedule_smem(prog, COLS, vec) <= MAX_SMEM,
           f"{name}: route {route} does not take these operands")
    with torch.cuda.device(rows.device):
        rc = _lib().ctt_xor_schedule(
            prog.on(rows.device, COLS * vec).data_ptr(), len(prog.code),
            prog.groups, prog.C, prog.n_vals, rows.data_ptr(), out.data_ptr(),
            row_bytes, vec, _stream(rows.device))
    _raise_on(rc, name)
    xor_schedule.launches += 1
    xor_schedule.routes[route] += 1
    xor_schedule.last = _shape(prog, route, row_bytes // vec, sms)
    return out


def _shape(prog: Program, route: str, columns: int, sms: int, **more) -> Dict:
    return {"route": route, "groups": prog.groups, "steps": prog.steps,
            "warps_per_sm": warps_per_sm(prog, columns, sms), **more}


def apply_packedbit(prog: Program, data: torch.Tensor, resident: bool = False,
                    words: Union[int, None] = None):
    """[out*8, k*8] program applied to [k, B] uint8 chunks (w=8 byte layout)
    -> [out, B] uint8; with resident, (that, the [(k+out)*8, ceil(B/32)]
    int32 data ‖ parity plane words).  `words` forces the plane words a
    lane holds (1 or 2); by default apply_packedbit_words picks it."""
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
    _check(words in (None,) + K4_WORDS, f"{name}: {words} words a lane")
    sms = _sm_count(data.device.index)
    if words is None:
        words = apply_packedbit_words(prog, W, sms)
    _check(words is not None
           and apply_packedbit_smem(prog, COLS * words) <= MAX_SMEM,
           f"{name}: a program of {len(prog.code)} instructions and "
           f"{prog.n_vals} values needs {apply_packedbit_smem(prog, COLS)} "
           f"bytes of shared memory at {COLS} word columns, over {MAX_SMEM}")
    out = torch.empty((out_rows, B), dtype=torch.uint8, device=data.device)
    planes = (torch.empty((k * 8 + prog.R, W), dtype=torch.int32,
                          device=data.device) if resident else None)
    with torch.cuda.device(data.device):
        rc = _lib().ctt_apply_packedbit(
            prog.on(data.device, COLS * 4 * words).data_ptr(), len(prog.code),
            prog.groups, k, out_rows, prog.n_vals, data.data_ptr(), B,
            out.data_ptr(), planes.data_ptr() if resident else None, words,
            _stream(data.device))
    _raise_on(rc, name)
    route = "resident" if resident else "apply"
    apply_packedbit.launches += 1
    apply_packedbit.routes[route] += 1
    apply_packedbit.last = _shape(prog, route, -(-W // words), sms,
                                  words=words)
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


def _check_table(name: str, table: PageTable, words: int) -> None:
    n = len(table.pages) * table.page_words
    _check(words <= n < 2 ** 31, f"{name}: {words} words in a page table of "
           f"{len(table.pages)} pages of {table.page_words} words")


def from_packedbit_paged(table: PageTable, w0: int, row_words: int,
                         out_rows: int, L: int, cs: int = 0,
                         object_size: int = 0) -> torch.Tensor:
    """Plane rows of a paged resident -> bytes, in one pass: the
    out_rows*8 rows of row_words words from the resident's word w0 give
    out_rows rows of L bytes (L <= 32*row_words).  cs = 0: those rows,
    [out_rows, L].  cs > 0: an object read, its stripe-major bytes (byte c
    of row o at (c // cs)*out_rows*cs + o*cs + c % cs; L a multiple of
    cs), the first object_size of them, flat."""
    name = "from_packedbit_paged"
    words = w0 + out_rows * 8 * row_words
    _check(w0 >= 0 and row_words >= 1 and 1 <= out_rows <= 65535
           and 0 <= L <= 32 * row_words, f"{name}: {out_rows} rows of {L} "
           f"bytes from {row_words} words a plane row at word {w0}")
    _check_table(name, table, words)
    _check(cs >= 0 and (not cs or (L % cs == 0 and object_size >= 0)),
           f"{name}: L {L}, cs {cs}, object_size {object_size}")
    if table.device.type == "cpu":
        return from_packedbit_paged_plain(table, w0, row_words, out_rows, L,
                                          cs, object_size)
    n = min(object_size, out_rows * L) if cs else out_rows * L
    out = torch.empty(n if cs else (out_rows, L), dtype=torch.uint8,
                      device=table.device)
    if n == 0:
        return out
    table.addr.record_stream(torch.cuda.current_stream(table.device))
    with torch.cuda.device(table.device):
        rc = _lib().ctt_from_packedbit_paged(
            table.addr.data_ptr(), len(table.pages), table.page_words, w0,
            row_words, out_rows, L, cs, n, out.data_ptr(), TRANSPOSE_THREADS,
            _stream(table.device))
    _raise_on(rc, name)
    from_packedbit_paged.launches += 1
    return out


def to_packedbit_paged(data: torch.Tensor, table: PageTable) -> None:
    """[n, B] uint8 -> its n*8 rows of ceil(B/32) plane words, written
    straight into the resident's pages (the table has just enough of them),
    and zeros over the rest of the last page."""
    name = "to_packedbit_paged"
    _check_device(name, data)
    _check(data.dtype == torch.uint8, f"{name}: data must be uint8, got "
           f"{data.dtype}")
    n, B = data.shape
    _check(1 <= n <= 65534 and B >= 1, f"{name}: shape {tuple(data.shape)} "
           "(1..65534 rows, B >= 1)")
    words = n * 8 * -(-B // 32)
    _check_table(name, table, words)
    _check(len(table.pages) == -(-words // table.page_words),
           f"{name}: {len(table.pages)} pages for {words} words")
    _check(data.device == table.device,
           f"{name}: data on {data.device}, pages on {table.device}")
    if data.device.type == "cpu":
        return to_packedbit_paged_plain(data, table)
    table.addr.record_stream(torch.cuda.current_stream(data.device))
    with torch.cuda.device(data.device):
        rc = _lib().ctt_to_packedbit_paged(
            data.data_ptr(), n, B, table.addr.data_ptr(), len(table.pages),
            table.page_words, TRANSPOSE_THREADS, _stream(data.device))
    _raise_on(rc, name)
    to_packedbit_paged.launches += 1


xor_schedule.launches = 0
xor_schedule.routes = dict.fromkeys(XOR_ROUTES, 0)
xor_schedule.last = None
apply_packedbit.launches = 0
apply_packedbit.routes = dict.fromkeys(APPLY_ROUTES, 0)
apply_packedbit.last = None
to_packedbit.launches = 0
from_packedbit.launches = 0
to_packedbit_paged.launches = 0
from_packedbit_paged.launches = 0
