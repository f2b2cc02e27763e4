"""The plain reference: jerasure's reed_sol_van and cauchy_good codes in NumPy.

Written from jerasure's published algorithms (reed_sol.c, cauchy.c,
jerasure.c) and nothing else: it imports NumPy alone, so it shares no code,
table or matrix with the program it judges.  GF(2^w) arithmetic uses w=8's
primitive polynomial 0x11d unless told otherwise; the control
(``ecbench/control.py``) builds the same codes over another polynomial.

    Code(profile)               the codec a profile names (reed_sol_van or
                                cauchy_good, w=8)
    Code.chunk_size(n)          jerasure's chunk size for an n-byte object
    Code.data_chunks(obj)       the object padded and carved into k chunks
    Code.encode(obj)            all k+m chunks, as a [k+m, chunk] array
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: jerasure's primitive polynomial for w=8 (galois.c, prim_poly[8])
POLY_W8 = 0x11D
SIZEOF_INT = 4


class Field:
    """GF(2^8) over `poly`: exp/log tables and the full product table."""

    def __init__(self, poly: int = POLY_W8) -> None:
        exp = np.zeros(512, dtype=np.int64)
        log = np.zeros(256, dtype=np.int64)
        x = 1
        for i in range(255):
            exp[i] = x
            log[x] = i
            x <<= 1
            if x & 0x100:
                x ^= poly
        if len(set(exp[:255].tolist())) != 255:
            raise ValueError(f"polynomial {poly:#x} is not primitive")
        exp[255:510] = exp[:255]
        self.poly, self.exp, self.log = poly, exp, log
        a = np.arange(256)
        table = exp[(log[:, None] + log[None, :]) % 255]
        table[0, :] = 0
        table[:, 0] = 0
        #: mul[a, b] = a * b, as uint8, one row a region multiply indexes
        self.mul = table.astype(np.uint8)
        self._a = a

    def multiply(self, a: int, b: int) -> int:
        return int(self.mul[a, b])

    def divide(self, a: int, b: int) -> int:
        if b == 0:
            raise ZeroDivisionError("division by zero in GF(2^8)")
        if a == 0:
            return 0
        return int(self.exp[(self.log[a] - self.log[b]) % 255])


def vandermonde_coding_matrix(f: Field, k: int, m: int) -> np.ndarray:
    """reed_sol_vandermonde_coding_matrix: the last m rows of
    reed_sol_big_vandermonde_distribution_matrix(k+m, k)."""
    rows, cols = k + m, k
    d = np.zeros((rows, cols), dtype=np.int64)
    d[0, 0] = 1
    d[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        v = 1
        for j in range(cols):
            d[i, j] = v
            v = f.multiply(v, i)
    for i in range(1, cols):
        j = next((r for r in range(i, rows) if d[r, i] != 0), None)
        if j is None:
            raise ValueError("vandermonde matrix is singular")
        if j != i:
            d[[i, j]] = d[[j, i]]
        if d[i, i] != 1:
            inv = f.divide(1, int(d[i, i]))
            d[:, i] = f.mul[inv, d[:, i]]
        for j in range(cols):
            e = int(d[i, j])
            if j != i and e != 0:
                d[:, j] ^= f.mul[e, d[:, i]]
    for j in range(cols):  # row k all ones: scale column j below the identity
        e = int(d[cols, j])
        if e != 1:
            inv = f.divide(1, e)
            d[cols:, j] = f.mul[inv, d[cols:, j]]
    for i in range(cols + 1, rows):  # first column ones: scale each row
        e = int(d[i, 0])
        if e != 1:
            inv = f.divide(1, e)
            d[i, :] = f.mul[d[i, :], inv]
    return d[k:].astype(np.uint8)


def bitmatrix(f: Field, matrix: np.ndarray) -> np.ndarray:
    """jerasure_matrix_to_bitmatrix at w=8: element e at (i, j) becomes the
    8x8 block whose column x holds the bits of e * 2^x."""
    m, k = matrix.shape
    out = np.zeros((m * 8, k * 8), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            e = int(matrix[i, j])
            for x in range(8):
                for bit in range(8):
                    out[i * 8 + bit, j * 8 + x] = (e >> bit) & 1
                e = f.multiply(e, 2)
    return out


def _n_ones(f: Field, e: int) -> int:
    return int(bitmatrix(f, np.array([[e]])).sum())


def cauchy_good_matrix(f: Field, k: int, m: int) -> np.ndarray:
    """cauchy_good_general_coding_matrix for m > 2: cauchy_original_coding_
    matrix (1 / (i ^ (m + j))), then cauchy_improve_coding_matrix."""
    if m <= 2:
        raise ValueError("m <= 2 takes jerasure's cbest tables, not built here")
    mat = np.array([[f.divide(1, i ^ (m + j)) for j in range(k)]
                    for i in range(m)], dtype=np.int64)
    for j in range(k):  # first row all ones
        if mat[0, j] != 1:
            inv = f.divide(1, int(mat[0, j]))
            mat[:, j] = f.mul[mat[:, j], inv]
    for i in range(1, m):  # each later row scaled to the fewest ones
        best = sum(_n_ones(f, int(e)) for e in mat[i])
        best_x = -1
        for x in range(k):
            if mat[i, x] != 1:
                inv = f.divide(1, int(mat[i, x]))
                n = sum(_n_ones(f, f.multiply(int(e), inv)) for e in mat[i])
                if n < best:
                    best, best_x = n, x
        if best_x != -1:
            inv = f.divide(1, int(mat[i, best_x]))
            mat[i] = f.mul[mat[i], inv]
    return mat.astype(np.uint8)


class Code:
    """A w=8 jerasure code named by its profile: reed_sol_van (byte layout,
    alignment k*w*sizeof(int)) or cauchy_good (packet layout, alignment
    k*w*packetsize*sizeof(int))."""

    def __init__(self, profile: Dict[str, str], poly: int = POLY_W8) -> None:
        self.technique = profile["technique"]
        self.k, self.m = int(profile["k"]), int(profile["m"])
        if int(profile.get("w", 8)) != 8:
            raise ValueError("the reference holds w=8 only")
        self.field = Field(poly)
        if self.technique == "reed_sol_van":
            self.matrix = vandermonde_coding_matrix(self.field, self.k, self.m)
            self.alignment = self.k * 8 * SIZEOF_INT
            self.packetsize = 0
        elif self.technique == "cauchy_good":
            self.packetsize = int(profile.get("packetsize", 2048))
            self.matrix = cauchy_good_matrix(self.field, self.k, self.m)
            self.bits = bitmatrix(self.field, self.matrix)
            self.alignment = self.k * 8 * self.packetsize * SIZEOF_INT
        else:
            raise ValueError(f"technique {self.technique} has no reference")

    def chunk_size(self, object_size: int) -> int:
        a = self.alignment
        padded = -(-object_size // a) * a if object_size else a
        return padded // self.k

    def data_chunks(self, obj) -> np.ndarray:
        """The object zero-padded to k chunks: [k, chunk] uint8."""
        raw = np.frombuffer(obj, dtype=np.uint8)
        cs = self.chunk_size(raw.size)
        buf = np.zeros(self.k * cs, dtype=np.uint8)
        buf[:raw.size] = raw
        return buf.reshape(self.k, cs)

    def coding_chunks(self, data: np.ndarray) -> np.ndarray:
        """[m, chunk] parity of [k, chunk] data chunks."""
        if self.technique == "reed_sol_van":
            out = np.zeros((self.m, data.shape[1]), dtype=np.uint8)
            for i in range(self.m):
                for j in range(self.k):
                    out[i] ^= self.field.mul[self.matrix[i, j]][data[j]]
            return out
        # packet layout: block b of chunk j holds packets x = 0..7, and
        # coding packet (i, l) is the XOR of the data packets (j, x) whose
        # bit (i*8+l, j*8+x) is set
        ps, k, m = self.packetsize, self.k, self.m
        nb = data.shape[1] // (8 * ps)
        rows = data.reshape(k, nb, 8, ps).transpose(0, 2, 1, 3).reshape(
            k * 8, nb, ps)
        out = np.zeros((m * 8, nb, ps), dtype=np.uint8)
        for r in range(m * 8):
            for c in np.flatnonzero(self.bits[r]):
                out[r] ^= rows[c]
        return out.reshape(m, 8, nb, ps).transpose(0, 2, 1, 3).reshape(
            m, nb * 8 * ps)

    def encode(self, obj) -> np.ndarray:
        """All k+m chunks of an object: [k+m, chunk] uint8."""
        data = self.data_chunks(obj)
        return np.concatenate([data, self.coding_chunks(data)])
