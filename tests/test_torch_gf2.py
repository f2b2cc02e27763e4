"""ceph_tpu_torch.ops against ceph_tpu.ops on the CPU: the two kernels' plain
versions against the Pallas kernels (interpret mode, at most one TILE_B of
columns) and the XLA lane, and the bit-plane layout helpers against their
JAX twins.  Inputs come from numpy.random.default_rng and are handed to both
packages; the tolerance is exact equality (integer GF(2) arithmetic).  The
CUDA kernels themselves are held to these plain versions on the card by
chip_smoke.py and tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import ceph_tpu.ops.gf2 as jgf2
from ceph_tpu.ec.matrices import (cauchy_good_matrix, liberation_bitmatrix,
                                  matrix_to_bitmatrix,
                                  vandermonde_coding_matrix)
from ceph_tpu.ops.pallas_gf2 import (TILE_B, pallas_apply_bytes_w8,
                                     pallas_gf2_matmul)
from ceph_tpu_torch.ops import cuda_gf2
from ceph_tpu_torch.ops import gf2 as tgf2


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def w8_bitmatrix(kind: str, k: int, m: int, rng) -> np.ndarray:
    if kind == "vandermonde":
        return matrix_to_bitmatrix(vandermonde_coding_matrix(k, m, 8), 8)
    return rng.integers(0, 2, size=(m * 8, k * 8), dtype=np.uint8)


@pytest.mark.parametrize("B", [1, 256, 1000, TILE_B + 17])
@pytest.mark.parametrize("kind", ["vandermonde", "random"])
@pytest.mark.parametrize("k,m", [(8, 3), (4, 2)])
def test_apply_bytes_w8_matches_jax(k, m, kind, B):
    rng = np.random.default_rng(k * 1000 + m * 100 + B)
    bm = w8_bitmatrix(kind, k, m, rng)
    data = rng.integers(0, 256, size=(k, B), dtype=np.uint8)
    got = cuda_gf2.apply_bytes_w8(t(bm.astype(np.int8)), t(data)).numpy()
    assert got.dtype == np.uint8 and got.shape == (m, B)
    assert np.array_equal(got, np.asarray(jgf2.gf2_apply_bytes(bm, data, 8, m)))
    if B <= TILE_B:
        want = np.asarray(pallas_apply_bytes_w8(bm, data, m, interpret=True))
        assert np.array_equal(got, want)
    assert np.array_equal(tgf2.gf2_apply_bytes(t(bm), t(data), 8, m).numpy(),
                          got)


@pytest.mark.parametrize("R,C,B", [(16, 32, 2048), (24, 64, 1000),
                                   (48, 128, 257), (8, 16, 1), (5, 200, 300)])
def test_gf2_matmul_matches_pallas(R, C, B):
    """Arbitrary int8 operands, negatives among them: only the low bits
    decide the parity, on both sides."""
    rng = np.random.default_rng(R * C + B)
    M = rng.integers(-128, 128, size=(R, C), dtype=np.int8)
    bits = rng.integers(-128, 128, size=(C, B), dtype=np.int8)
    got = cuda_gf2.gf2_matmul(t(M), t(bits)).numpy()
    want = np.asarray(pallas_gf2_matmul(M, bits, interpret=True))
    assert got.dtype == np.int8 and np.array_equal(got, want)
    assert np.array_equal(tgf2.gf2_matmul(t(M), t(bits)).numpy(), want)
    assert np.array_equal(
        got, np.asarray(jgf2.gf2_matmul(M & 1, bits & 1)))


@pytest.mark.parametrize("call,args,match", [
    ("apply_bytes_w8", (np.zeros((24, 64), np.uint8), np.zeros((8, 4), np.uint8)),
     "int8"),
    ("apply_bytes_w8", (np.zeros((24, 64), np.int8), np.zeros((8, 4), np.int8)),
     "uint8"),
    ("apply_bytes_w8", (np.zeros((24, 64), np.int8), np.zeros((4, 4), np.uint8)),
     "columns"),
    ("apply_bytes_w8", (np.zeros((20, 64), np.int8), np.zeros((8, 4), np.uint8)),
     "multiple of 8"),
    ("apply_bytes_w8", (np.zeros((24, 64), np.int8), np.zeros((8, 0), np.uint8)),
     "empty"),
    ("gf2_matmul", (np.zeros((4, 4096), np.int8), np.zeros((4096, 8), np.int8)),
     "limits"),
    ("gf2_matmul", (np.zeros((4, 8), np.int8), np.zeros((8,), np.int8)),
     "2-D"),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(call, args, match):
    with pytest.raises(ValueError, match=match):
        getattr(cuda_gf2, call)(*(t(a) for a in args))


@pytest.mark.parametrize("k,out_rows,B,addresses,route", [
    (8, 3, 524288, (0, 256, 512), "xor"),       # reed_sol_van k=8 m=3
    (8, 1, 4096, (0, 256, 512), "xor"),
    (16, 4, 4112, (0, 256, 512), "xor"),        # the widest xor shape
    (12, 4, 10004, (0, 256, 512), "popc.v4"),   # B % 16 != 0
    (8, 3, 4096, (0, 260, 512), "popc.v4"),     # data base + 4
    (8, 3, 4096, (8, 256, 512), "popc.v4"),     # bit-matrix base + 8
    (8, 3, 4096, (0, 257, 512), "popc.b1"),     # data base + 1
    (17, 3, 4096, (0, 256, 512), "popc.v4"),    # k > 16
    (8, 5, 4096, (0, 256, 512), "popc.v4"),     # out_rows > 4
    (40, 2, 3000, (0, 256, 512), "popc.b1"),    # k > 32: one column a thread
    (20, 3, 1002, (0, 256, 512), "popc.b1"),    # B % 4 != 0
    (20, 3, 1000, (1, 256, 512), "popc.v4"),    # popc ignores the matrix base
])
def test_apply_bytes_w8_route_rule(k, out_rows, B, addresses, route):
    """The routing rule of csrc/gf2.cu k1_route, as the wrapper mirrors it:
    shape and alignment alone decide, with no knob."""
    assert cuda_gf2.apply_bytes_w8_route(k, out_rows, B, *addresses) == route
    assert route in cuda_gf2.K1_ROUTES


def _prmt(a: np.ndarray, b: np.ndarray, sel: np.ndarray) -> np.ndarray:
    """PTX prmt.b32 in its default mode on uint32 arrays, for selectors whose
    nibbles never ask for sign replication."""
    a, b, sel = np.broadcast_arrays(*(np.asarray(v, np.uint64) for v in (a, b, sel)))
    pool = (b << np.uint64(32)) | a
    out = np.zeros(a.shape, np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(15)
        assert not (nib & np.uint64(8)).any()
        out |= ((pool >> (np.uint64(8) * nib)) & np.uint64(0xff)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def xor_route_model(bm: np.ndarray, data: np.ndarray) -> np.ndarray:
    """numpy model of the xor route's index maps (csrc/gf2.cu): per 8x8 block
    (o, j) of the bit-matrix, three 8-entry byte tables of the block applied
    to bits 0-2, 3-5 and 6-7 of a byte; per data word of four columns, three
    selectors whose nibbles hold those fields of columns 0, 2, 1, 3; one prmt
    lookup per table, XORed, then a prmt back to column order."""
    k, B = data.shape
    out_rows = bm.shape[0] // 8
    cols = -(-B // 4) * 4
    words = np.zeros((k, cols), np.uint8)
    words[:, :B] = data
    words = words.view("<u4").astype(np.uint32)
    # column b of block (o, j) as a byte: bit x = bm[o*8+x, j*8+b] & 1
    block = (bm.astype(np.int64) & 1).reshape(out_rows, 8, k, 8)
    colbyte = (block << np.arange(8)[None, :, None, None]).sum(axis=1)
    acc = np.zeros((out_rows, words.shape[1]), np.uint32)
    for g, mask in ((0, 0x07070707), (1, 0x07070707), (2, 0x03030303)):
        entries = np.zeros((out_rows, k, 8), np.int64)
        for e in range(8):
            for i in range(3):
                if (e >> i) & 1 and 3 * g + i < 8:
                    entries[:, :, e] ^= colbyte[:, :, 3 * g + i]
        lo = (entries[:, :, :4] << (8 * np.arange(4))).sum(axis=-1)
        hi = (entries[:, :, 4:] << (8 * np.arange(4))).sum(axis=-1)
        for j in range(k):
            v = (words[j] >> np.uint32(3 * g)) & np.uint32(mask)
            sel = v | (v >> np.uint32(12))
            acc ^= _prmt(lo[:, j, None], hi[:, j, None], sel[None, :])
    out = _prmt(acc, 0, 0x3120)
    return np.ascontiguousarray(out).view(np.uint8)[:, :B]


@pytest.mark.parametrize("k,out_rows,B", [(8, 3, 1000), (8, 1, 37),
                                          (16, 4, 256), (3, 2, 5)])
def test_xor_route_model_matches_plain(k, out_rows, B):
    """The xor route's table and selector maps, modelled in numpy, give the
    plain version's bytes: a layout fault shows here, not on the card."""
    rng = np.random.default_rng(k * 100 + out_rows + B)
    bm = rng.integers(-128, 128, size=(out_rows * 8, k * 8), dtype=np.int8)
    data = rng.integers(0, 256, size=(k, B), dtype=np.uint8)
    want = cuda_gf2.apply_bytes_w8_plain(t(bm), t(data)).numpy()
    assert np.array_equal(xor_route_model(bm, data), want)


@pytest.mark.parametrize("R,C,B,addresses,route", [
    (24, 64, 524288, (0, 256), "mma"),      # cauchy_good k=8 m=3 encode
    (64, 64, 524288, (0, 256), "mma"),      # its 3-erasure decode
    (48, 128, 2097152, (0, 256), "mma"),    # reed_sol_van k=8 m=3 w=16
    (64, 128, 16, (0, 256), "mma"),         # the widest mma shape
    (5, 40, 1040, (0, 256), "mma"),         # R and C zero-padded
    (65, 64, 4096, (0, 256), "popc.v4"),    # R > 64
    (24, 129, 4096, (0, 256), "popc.v4"),   # C > 128
    (24, 64, 1000, (0, 256), "popc.v4"),    # B % 16 != 0
    (24, 64, 4096, (4, 256), "popc.v4"),    # bits base + 4
    (24, 64, 4096, (0, 264), "popc.v4"),    # out base + 8
    (24, 64, 4096, (1, 256), "popc.b1"),    # bits base + 1
    (24, 64, 1001, (0, 256), "popc.b1"),    # B % 4 != 0
])
def test_gf2_matmul_route_rule(R, C, B, addresses, route):
    """The routing rule of csrc/gf2.cu k2_route, as the wrapper mirrors it:
    shape and alignment alone decide, with no knob."""
    assert cuda_gf2.gf2_matmul_route(R, C, B, *addresses) == route
    assert route in cuda_gf2.K2_ROUTES


MMA_TILE, MMA_PITCH = 256, 288  # csrc/gf2.cu kMmaTile, kMmaPitch


def test_mma_route_pitch_is_free_of_bank_conflicts():
    """The stage's row pitch (csrc/gf2.cu kMmaPitch, the tile plus 32
    bytes) is a multiple of 16, as bulk-copy destinations must be, and puts
    the 32 words a warp loads at once (rows 4i+t, t = 0..3, columns 4g, g =
    0..7, of one 32-column block) in 32 different banks."""
    pitch = MMA_PITCH
    assert pitch % 16 == 0
    for block in range(MMA_TILE // 32):
        for i in range(8):  # i = 0..3 and the upper half 16 + 4i
            banks = {((4 * i + t) * pitch + block * 32 + 4 * g) // 4 % 32
                     for t in range(4) for g in range(8)}
            assert len(banks) == 32


def mma_route_model(M: np.ndarray, bits: np.ndarray, rng) -> np.ndarray:
    """numpy model of the mma route's index maps (csrc/gf2.cu
    gf2_matmul_mma_kernel), lane by lane, for B a multiple of 16.  A warp
    takes one 32-column block of a stage at a time; rows past C and columns
    past B hold garbage, as shared memory does.  A fragments: lane (g, t),
    register q, byte i is M[16mt + g + 8(q&1), 32kt + 16(q>>1) + 4i + t] & 1.
    B fragments: four 32-bit loads of rows 4i+t (and 16+4i+t) at columns
    4g..4g+3 of the lane's 32-column block, a 4x4 byte transpose by prmt,
    word j for n-tile j.  mma m16n8k32 s8 by the PTX fragment tables, then
    the epilogue's prmt packing of rows g and g+8 at columns 8t..8t+7."""
    R, C = M.shape
    B = bits.shape[1]
    MT, KT = -(-R // 16), -(-C // 32)
    nblk = -(-B // 32)
    stage = rng.integers(-128, 128, size=(KT * 32, nblk * 32), dtype=np.int8)
    stage[:C, :B] = bits
    # word of lane g in a block: columns 4g..4g+3, little-endian
    words = stage.view(np.uint8).reshape(KT * 32, nblk, 8, 4).copy()
    words = words.view("<u4")[..., 0].astype(np.uint32)  # [row, blk, g]
    Mp = np.zeros((MT * 16, KT * 32), np.int64)
    Mp[:R, :C] = M.astype(np.int64) & 1
    g_of, t_of = np.arange(32) // 4, np.arange(32) % 4
    u8 = np.uint32(0xff)

    acc = np.zeros((MT, 4, 32, 4, nblk), np.uint32)  # [mt, j, lane, q, blk]
    for kt in range(KT):
        # b[h][j][lane, blk]: byte i = row 32kt + 16h + 4i + t, column 4g + j
        b = np.zeros((2, 4, 32, nblk), np.uint32)
        for h in range(2):
            w = [words[32 * kt + 16 * h + 4 * i + t_of, :, g_of] for i in range(4)]
            x0, x1 = _prmt(w[0], w[1], 0x5140), _prmt(w[0], w[1], 0x7362)
            y0, y1 = _prmt(w[2], w[3], 0x5140), _prmt(w[2], w[3], 0x7362)
            b[h] = [_prmt(x0, y0, 0x5410), _prmt(x0, y0, 0x7632),
                    _prmt(x1, y1, 0x5410), _prmt(x1, y1, 0x7632)]
        for mt in range(MT):
            a = np.zeros((32, 4), np.uint32)  # the kernel's A fragments
            for q in range(4):
                for i in range(4):
                    a[:, q] |= (Mp[16 * mt + g_of + 8 * (q & 1),
                                   32 * kt + 16 * (q >> 1) + 4 * i + t_of]
                                .astype(np.uint32) << np.uint32(8 * i))
            A = np.zeros((16, 32), np.int64)  # PTX table: a_q byte i
            for lane in range(32):
                g, t = divmod(lane, 4)
                for q in range(4):
                    for i in range(4):
                        A[g + 8 * (q & 1), 16 * (q >> 1) + 4 * t + i] = \
                            (a[lane, q] >> np.uint32(8 * i)) & u8
            for j in range(4):
                Bm = np.zeros((nblk, 32, 8), np.int64)  # PTX table: b_h byte i
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for h in range(2):
                        for i in range(4):
                            v = (b[h, j, lane] >> np.uint32(8 * i)) & u8
                            Bm[:, 16 * h + 4 * t + i, g] = v.astype(np.int8)
                D = np.einsum("mk,zkn->zmn", A, Bm)
                for lane in range(32):
                    g, t = divmod(lane, 4)
                    for q in range(4):
                        acc[mt, j, lane, q] += D[:, g + 8 * (q >> 1),
                                                 2 * t + (q & 1)].astype(np.uint32)
    out = np.zeros((MT * 16, nblk * 32), np.uint8)
    for mt in range(MT):
        for lane in range(32):
            g, t = divmod(lane, 4)
            for h in range(2):
                half = [_prmt(_prmt(acc[mt, 0, lane, q], acc[mt, 1, lane, q], 0x0040),
                              _prmt(acc[mt, 2, lane, q], acc[mt, 3, lane, q], 0x0040),
                              0x5410) & np.uint32(0x01010101)
                        for q in (2 * h, 2 * h + 1)]
                row = np.stack(half, axis=-1).astype("<u4").view(np.uint8)
                cols = np.arange(nblk)[:, None] * 32 + 8 * t + np.arange(8)
                out[16 * mt + g + 8 * h, cols] = row
    return out[:R, :B].view(np.int8)


@pytest.mark.parametrize("R,C,B", [(24, 64, 528), (64, 64, 256),
                                   (48, 128, 272), (5, 40, 48), (17, 100, 32)])
def test_mma_route_model_matches_plain_and_pallas(R, C, B):
    """The mma route's fragment maps, modelled in numpy, give the plain
    version's and the Pallas kernel's bits for int8 operands, negatives
    among them: a layout fault shows here, not on the card."""
    rng = np.random.default_rng(R * 1000 + C + B)
    M = rng.integers(-128, 128, size=(R, C), dtype=np.int8)
    bits = rng.integers(-128, 128, size=(C, B), dtype=np.int8)
    got = mma_route_model(M, bits, rng)
    assert np.array_equal(got, cuda_gf2.gf2_matmul_plain(t(M), t(bits)).numpy())
    assert np.array_equal(got, np.asarray(pallas_gf2_matmul(M, bits,
                                                            interpret=True)))


def test_kernel_wrappers_refuse_non_contiguous():
    bits = torch.zeros((16, 64), dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_gf2.gf2_matmul(torch.zeros((4, 8), dtype=torch.int8), bits[::2])


@pytest.mark.parametrize("w,B", [(8, 1000), (16, 1000), (4, 999)])
def test_unpack_pack_match_jax(w, B):
    rng = np.random.default_rng(w + B)
    data = rng.integers(0, 256, size=(3, B), dtype=np.uint8)
    bits = tgf2.unpack_bits_bytes(t(data), w)
    assert bits.dtype == torch.int8
    assert np.array_equal(bits.numpy(),
                          np.asarray(jgf2.unpack_bits_bytes(data, w)))
    assert np.array_equal(tgf2.to_planar(t(data), w).numpy(), bits.numpy())
    assert np.array_equal(tgf2.pack_bits_bytes(bits, w, 3).numpy(), data)
    planes = rng.integers(0, 2, size=tuple(bits.shape), dtype=np.int8)
    assert np.array_equal(tgf2.from_planar(t(planes), w, 3).numpy(),
                          np.asarray(jgf2.pack_bits_bytes(planes, w, 3)))


@pytest.mark.parametrize("w,k,m,B", [(16, 3, 2, 1000), (4, 4, 2, 999),
                                     (8, 4, 2, 640)])
def test_apply_bytes_and_resident_match_jax(w, k, m, B):
    rng = np.random.default_rng(w * k + B)
    bm = matrix_to_bitmatrix(vandermonde_coding_matrix(k, m, w), w)
    data = rng.integers(0, 256, size=(k, B), dtype=np.uint8)
    got = tgf2.gf2_apply_bytes(t(bm), t(data), w, m).numpy()
    assert np.array_equal(got, np.asarray(jgf2.gf2_apply_bytes(bm, data, w, m)))
    packed, planes = tgf2.gf2_encode_resident(t(bm), t(data), w, m)
    jpacked, jplanes = jgf2.gf2_encode_resident(bm, data, w, m)
    assert np.array_equal(packed.numpy(), np.asarray(jpacked))
    assert np.array_equal(planes.numpy(), np.asarray(jplanes))


@pytest.mark.parametrize("name,w,k,m,p,nb", [
    ("cauchy_good", 8, 4, 2, 8, 3),
    ("cauchy_good", 8, 8, 3, 16, 2),
    ("liberation", 7, 4, 2, 4, 2),
])
def test_apply_packets_matches_jax(name, w, k, m, p, nb):
    if name == "liberation":
        bm = liberation_bitmatrix(k, w)
    else:
        bm = matrix_to_bitmatrix(cauchy_good_matrix(k, m, w), w)
    rng = np.random.default_rng(k * p + nb)
    data = rng.integers(0, 256, size=(k, nb * w * p), dtype=np.uint8)
    got = tgf2.gf2_apply_packets(t(bm), t(data), w, p, m).numpy()
    want = np.asarray(jgf2.gf2_apply_packets(bm, data, w, p, m))
    assert got.shape == (m, nb * w * p) and np.array_equal(got, want)


def test_bitmatrix_to_tensor():
    bm = matrix_to_bitmatrix(vandermonde_coding_matrix(4, 2, 8), 8)
    got = tgf2.bitmatrix_to_tensor(bm, "cpu")
    assert got.dtype == torch.int8 and got.is_contiguous()
    assert got.device.type == "cpu" and np.array_equal(got.numpy(), bm)
