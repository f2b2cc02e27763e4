"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports nothing of JAX or ceph_tpu, so it runs where only the port does:

    python -m pytest tests/test_torch_cuda.py -q     # on a machine with a card

Where CUDA is absent every test here skips."""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.ec.matrices import (cauchy_good_matrix, matrix_to_bitmatrix,
                                        vandermonde_coding_matrix)
from ceph_tpu_torch.ec.plugins.cuda import CudaPlugin
from ceph_tpu_torch.ec.plugins.jerasure import JerasurePlugin
from ceph_tpu_torch.ops import cuda_gf2

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
    launches = cuda_gf2.apply_bytes_w8.launches + cuda_gf2.gf2_matmul.launches
    ec, ej = cuda.encode(set(range(n)), obj), cpu.encode(set(range(n)), obj)
    assert cuda_gf2.apply_bytes_w8.launches + cuda_gf2.gf2_matmul.launches \
        > launches
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
