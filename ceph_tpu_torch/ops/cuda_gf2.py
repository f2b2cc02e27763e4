"""The bit-plane GF(2) kernels on Hopper: wrappers, plain versions, launch counts.

Counterpart of ceph_tpu/ops/pallas_gf2.py.  Its two Pallas kernels become two
CUDA C++ kernels in ``csrc/gf2.cu`` (design, bound and what the design does
about it are noted there):

* ``apply_bytes_w8``  <- ``pallas_apply_bytes_w8``: an [out*8, k*8] bit-matrix
  applied to [k, B] uint8 chunks in the w=8 byte layout -> [out, B] uint8, on
  one of two routes chosen by shape and alignment (``apply_bytes_w8_route``): a
  popcount-free XOR kernel for k <= 16 and out <= 4 on 16-byte aligned rows,
  popcounts for any other shape;
* ``gf2_matmul``      <- ``pallas_gf2_matmul``: (M[R, C] @ bits[C, B]) & 1 on
  int8 operands -> [R, B] int8, on one of two routes chosen by shape and
  alignment (``gf2_matmul_route``): int8 tensor cores fed by bulk
  asynchronous copies through a ring in shared memory for R <= 64 and
  C <= 128 on 16-byte aligned rows, popcounts for any other shape.

Each wrapper checks device, dtype, shape and contiguity and raises on what the
kernel does not take (the same checks on every device).  On a CUDA tensor it
launches the kernel on PyTorch's current stream and counts the launch in its
``launches`` attribute (``routes`` also counts them by route); a launch error
raises, nothing falls back or retries on the other route.
``apply_bytes_w8_popc`` and ``gf2_matmul_popc`` force the popcount route, so
that the two routes can be timed on the same operands.  On a CPU
tensor it returns the plain PyTorch version, which exists for the CPU and for
holding the kernel to on the card.  Neither takes a column tile: any B >= 1.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ceph_tpu_torch.ops import build

#: limits of csrc/gf2.cuh: row masks fit 48 KiB of shared memory, and a
#: column's bit vector is at most 32 words of 64 bits
MAX_MASK_BYTES = 48 * 1024
MAX_MASK_WORDS = 32

#: K1's routes, by the code ctt_apply_bytes_w8_route returns: the XOR kernel,
#: the popcount kernel with 4-byte or byte accesses
K1_ROUTES = ("xor", "popc.v4", "popc.b1")

#: K2's routes, by the code ctt_gf2_matmul_route returns: the int8
#: tensor-core kernel, the popcount kernel with 4-byte or byte accesses
K2_ROUTES = ("mma", "popc.v4", "popc.b1")

#: the widest bit-matrix the mma route takes (csrc/gf2.cu kMmaMaxR, kMmaMaxC)
MMA_MAX_R = 64
MMA_MAX_C = 128


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library, built at first use, with its C signatures bound."""
    lib = build.load("gf2")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.ctt_apply_bytes_w8, lib.ctt_apply_bytes_w8_popc):
        fn.argtypes = [p, p, p, i, i, ll, p]
        fn.restype = i
    lib.ctt_apply_bytes_w8_route.argtypes = [p, p, p, i, i, ll]
    lib.ctt_apply_bytes_w8_route.restype = i
    for fn in (lib.ctt_gf2_matmul, lib.ctt_gf2_matmul_popc):
        fn.argtypes = [p, p, p, i, i, ll, p]
        fn.restype = i
    lib.ctt_gf2_matmul_route.argtypes = [p, p, i, i, ll]
    lib.ctt_gf2_matmul_route.restype = i
    lib.ctt_error_string.argtypes = [i]
    lib.ctt_error_string.restype = ctypes.c_char_p
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_operands(name: str, mbits: torch.Tensor, x: torch.Tensor,
                    x_dtype: torch.dtype, rows_per_col: int) -> None:
    _check(mbits.dtype == torch.int8, f"{name}: bit-matrix must be int8, "
           f"got {mbits.dtype}")
    _check(x.dtype == x_dtype, f"{name}: data must be {x_dtype}, got {x.dtype}")
    _check(mbits.dim() == 2 and x.dim() == 2,
           f"{name}: operands must be 2-D, got {tuple(mbits.shape)} and "
           f"{tuple(x.shape)}")
    _check(mbits.device == x.device, f"{name}: operands on {mbits.device} "
           f"and {x.device}")
    _check(x.device.type in ("cpu", "cuda"), f"{name}: device {x.device}")
    _check(mbits.is_contiguous() and x.is_contiguous(),
           f"{name}: operands must be contiguous")
    R, C = mbits.shape
    _check(C == x.shape[0] * rows_per_col,
           f"{name}: bit-matrix has {C} columns for {x.shape[0]} data rows")
    _check(R >= 1 and x.shape[0] >= 1 and x.shape[1] >= 1,
           f"{name}: empty operand {tuple(mbits.shape)} x {tuple(x.shape)}")
    words = -(-C // 64)
    _check(words <= MAX_MASK_WORDS and R * words * 8 <= MAX_MASK_BYTES,
           f"{name}: a [{R}, {C}] bit-matrix exceeds the kernel's row-mask "
           f"limits ({MAX_MASK_WORDS} words, {MAX_MASK_BYTES} bytes)")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = _lib().ctt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _parity_product(mbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(M @ bits) & 1 as int32 0/1.  The parity of a sum of products depends
    only on each operand's low bit, so `& 1` first is exact for any int8.  The
    product runs in float32: its sums (at most C <= 2048) are exact there,
    and it needs no integer matmul, which CUDA builds of PyTorch lack."""
    acc = (mbits & 1).to(torch.float32) @ (bits & 1).to(torch.float32)
    return acc.to(torch.int32) & 1


def apply_bytes_w8_plain(mbits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of apply_bytes_w8: unpack to bit-planes (row
    j*8+x = bit x of chunk j), parity product, pack 8 planes per byte (bit x
    of output row o = plane o*8+x)."""
    k, B = data.shape
    out_rows = mbits.shape[0] // 8
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = ((data[:, None, :] >> shifts[None, :, None]) & 1).reshape(k * 8, B)
    parity = _parity_product(mbits, bits).reshape(out_rows, 8, B)
    weights = torch.ones(8, dtype=torch.int32, device=data.device) << shifts.int()
    return (parity * weights[None, :, None]).sum(dim=1).to(torch.uint8)


def gf2_matmul_plain(mbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gf2_matmul."""
    return _parity_product(mbits, bits).to(torch.int8)


def _popc_route(k: int, B: int, data_addr: int, out_addr: int) -> str:
    vec = k <= 32 and B % 4 == 0 and data_addr % 4 == 0 and out_addr % 4 == 0
    return "popc.v4" if vec else "popc.b1"


def apply_bytes_w8_route(k: int, out_rows: int, B: int, mbits_addr: int,
                         data_addr: int, out_addr: int) -> str:
    """The route ctt_apply_bytes_w8 takes for k data rows, out_rows parity
    rows, B columns and these operand addresses (csrc/gf2.cu k1_route): the
    XOR kernel for k <= 16 and out_rows <= 4 where B and the three addresses
    are multiples of 16; else the popcount kernel, with 4-byte accesses where
    k <= 32 and B and the data and output addresses are multiples of 4."""
    if k <= 16 and out_rows <= 4 and all(
            n % 16 == 0 for n in (B, mbits_addr, data_addr, out_addr)):
        return "xor"
    return _popc_route(k, B, data_addr, out_addr)


def _check_w8(mbits: torch.Tensor, data: torch.Tensor) -> None:
    _check_operands("apply_bytes_w8", mbits, data, torch.uint8, 8)
    _check(mbits.shape[0] % 8 == 0, "apply_bytes_w8: bit-matrix rows "
           f"{mbits.shape[0]} are not a multiple of 8")


def _launch_w8(mbits: torch.Tensor, data: torch.Tensor,
               popc: bool) -> torch.Tensor:
    k, B = data.shape
    out_rows = mbits.shape[0] // 8
    out = torch.empty((out_rows, B), dtype=torch.uint8, device=data.device)
    if popc:
        entry = _lib().ctt_apply_bytes_w8_popc
        route = _popc_route(k, B, data.data_ptr(), out.data_ptr())
    else:
        entry = _lib().ctt_apply_bytes_w8
        route = apply_bytes_w8_route(k, out_rows, B, mbits.data_ptr(),
                                     data.data_ptr(), out.data_ptr())
    with torch.cuda.device(data.device):
        rc = entry(mbits.data_ptr(), data.data_ptr(), out.data_ptr(), k,
                   out_rows, B, _stream(data.device))
    _raise_on(rc, "apply_bytes_w8")
    apply_bytes_w8.launches += 1
    apply_bytes_w8.routes[route] += 1
    return out


def apply_bytes_w8(mbits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """[out*8, k*8] int8 bit-matrix applied to [k, B] uint8 chunks (w=8 byte
    layout) -> [out, B] uint8, on the route apply_bytes_w8_route names."""
    _check_w8(mbits, data)
    if data.device.type == "cpu":
        return apply_bytes_w8_plain(mbits, data)
    return _launch_w8(mbits, data, popc=False)


def apply_bytes_w8_popc(mbits: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """apply_bytes_w8 on the popcount route whatever the shape: the first
    port's kernel, kept callable so that the two routes can be held against
    each other on the card.  On a CPU tensor, the plain version."""
    _check_w8(mbits, data)
    if data.device.type == "cpu":
        return apply_bytes_w8_plain(mbits, data)
    return _launch_w8(mbits, data, popc=True)


def gf2_matmul_route(R: int, C: int, B: int, bits_addr: int,
                     out_addr: int) -> str:
    """The route ctt_gf2_matmul takes for an [R, C] bit-matrix, B columns and
    these operand addresses (csrc/gf2.cu k2_route): the int8 tensor-core
    kernel for R <= 64 and C <= 128 where B and the input and output
    addresses are multiples of 16; else the popcount kernel, with 4-byte
    accesses where B and those addresses are multiples of 4."""
    if R <= MMA_MAX_R and C <= MMA_MAX_C and all(
            n % 16 == 0 for n in (B, bits_addr, out_addr)):
        return "mma"
    return _k2_popc_route(B, bits_addr, out_addr)


def _k2_popc_route(B: int, bits_addr: int, out_addr: int) -> str:
    vec = all(n % 4 == 0 for n in (B, bits_addr, out_addr))
    return "popc.v4" if vec else "popc.b1"


def _launch_k2(mbits: torch.Tensor, bits: torch.Tensor,
               popc: bool) -> torch.Tensor:
    R, C = mbits.shape
    B = bits.shape[1]
    out = torch.empty((R, B), dtype=torch.int8, device=bits.device)
    if popc:
        entry = _lib().ctt_gf2_matmul_popc
        route = _k2_popc_route(B, bits.data_ptr(), out.data_ptr())
    else:
        entry = _lib().ctt_gf2_matmul
        route = gf2_matmul_route(R, C, B, bits.data_ptr(), out.data_ptr())
    with torch.cuda.device(bits.device):
        rc = entry(mbits.data_ptr(), bits.data_ptr(), out.data_ptr(), R, C, B,
                   _stream(bits.device))
    _raise_on(rc, "gf2_matmul")
    gf2_matmul.launches += 1
    gf2_matmul.routes[route] += 1
    return out


def gf2_matmul(mbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """(M[R, C] @ bits[C, B]) & 1 on int8 operands -> [R, B] int8 0/1, on the
    route gf2_matmul_route names."""
    _check_operands("gf2_matmul", mbits, bits, torch.int8, 1)
    if bits.device.type == "cpu":
        return gf2_matmul_plain(mbits, bits)
    return _launch_k2(mbits, bits, popc=False)


def gf2_matmul_popc(mbits: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """gf2_matmul on the popcount route whatever the shape: the first port's
    kernel, kept callable so that the two routes can be held against each
    other on the card.  On a CPU tensor, the plain version."""
    _check_operands("gf2_matmul", mbits, bits, torch.int8, 1)
    if bits.device.type == "cpu":
        return gf2_matmul_plain(mbits, bits)
    return _launch_k2(mbits, bits, popc=True)


apply_bytes_w8.launches = 0
apply_bytes_w8.routes = dict.fromkeys(K1_ROUTES, 0)
gf2_matmul.launches = 0
gf2_matmul.routes = dict.fromkeys(K2_ROUTES, 0)
