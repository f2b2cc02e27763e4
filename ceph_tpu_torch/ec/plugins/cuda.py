"""plugin=cuda — the jerasure techniques with their GF(2) work on the GPU.

Counterpart of ceph_tpu/ec/plugins/tpu.py.  Profiles say ``plugin=cuda
technique=reed_sol_van k=8 m=3``; the codec subclasses the jerasure technique
classes, so chunk sizes, padding, matrices and decode selection are literally
shared, and its chunks are byte-identical to plugin=jerasure's.  Only the two
compute seams are overridden: ``_apply`` (byte layout: reed_sol_van,
reed_sol_r6_op at w=4/8/16) and ``_apply_rows`` (packet layout: cauchy_orig,
cauchy_good, liberation, blaum_roth, liber8tion).  Each copies the host
regions to the codec's device, applies the bit-matrix there through
ops/gf2.py and copies the result back.  As plugin=tpu does, w=8 ``_apply``
and every ``_apply_rows`` take the packed-bit XOR-schedule lane while
``packedbit_enabled()`` (CEPH_TPU_PACKEDBIT, default on): one
``gf2_apply_packedbit`` launch per w=8 call, one ``gf2_xor_packed`` launch on
the raw packet bytes per packet-row call (kernels in ops/csrc/packedbit.cu).
Otherwise, and for w=16 and w=4, the int8-plane lane runs (ops/csrc/gf2.cu).
Bit-matrices are cached per codec, keyed by matrix: on the host for the
schedule lane (whose programs the gf2 schedule LRU keeps), on the device
for the int8-plane lane, in one dict.

The device is the factory call's (ec/registry.py): ``device=None`` builds
codecs on the current CUDA device, ``"cuda:N"`` on that card and ``"cpu"`` on
the CPU, where the same lane runs the kernels' plain versions.  Asking for
CUDA where there is none fails the factory with -ENODEV.  A dispatch error propagates as an
ErasureCodeError(-EIO) carrying its cause; nothing falls back to another
device, so a result always comes from the device the codec was built for.
"""

from __future__ import annotations

import errno
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch

from ceph_tpu_torch import PLUGIN_ABI_VERSION
from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder
from ceph_tpu_torch.common.tracing import span
from ceph_tpu_torch.ec.interface import ErasureCodeError, ErasureCodeProfile
from ceph_tpu_torch.ec.matrices import matrix_to_bitmatrix
from ceph_tpu_torch.ec.plugins.jerasure import (
    BlaumRoth,
    CauchyGood,
    CauchyOrig,
    Liber8tion,
    Liberation,
    ReedSolomonR6Op,
    ReedSolomonVandermonde,
)
from ceph_tpu_torch.ec.registry import ErasureCodePlugin
from ceph_tpu_torch.ops.gf2 import (bitmatrix_to_tensor, gf2_apply_bytes,
                                    gf2_apply_packedbit, gf2_apply_packets,
                                    gf2_xor_packed, packedbit_enabled)
from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device

# The `ec_plugin` counter set, same schema as plugin=tpu's: direct codec
# calls through the _apply/_apply_rows seams.  COUNTER SCHEMA:
#   apply / apply_rows        u64         CUDA dispatches per seam
#   apply_s / apply_rows_s    longrunavg  seconds per CUDA dispatch,
#                                         host->device and back included
#   h2d_s                     longrunavg  seconds a dispatch hands its input
#                                         to the card: contiguous host copy,
#                                         from_numpy, .to(device)
#   launch_s                  longrunavg  seconds in the lane's call: the
#                                         schedule LRU lookup or bit-matrix,
#                                         the kernel enqueue
#   d2h_s                     longrunavg  seconds in out.cpu().numpy(): the
#                                         wait for the kernel, the copy back
#   (h2d_s, launch_s and d2h_s time steps inside apply_s / apply_rows_s, so
#   their sums stay at or under the seam's)
#   cpu_fallback              u64         seam calls served on the CPU by a
#                                         codec built with device="cpu"
#   device_failed             u64         dispatch errors, each raised to the
#                                         caller as ErasureCodeError(-EIO)
PLUGIN_PERF = (
    PerfCountersBuilder("ec_plugin")
    .add_u64_counter("apply", "byte-layout seam device dispatches")
    .add_u64_counter("apply_rows", "packet-layout seam device dispatches")
    .add_time_avg("apply_s", "byte-layout seam device seconds")
    .add_time_avg("apply_rows_s", "packet-layout seam device seconds")
    .add_time_avg("h2d_s", "seam seconds handing the input to the card")
    .add_time_avg("launch_s", "seam seconds in the lane call (enqueue)")
    .add_time_avg("d2h_s", "seam seconds waiting for and copying back")
    .add_u64_counter("cpu_fallback",
                     "seam calls served on the CPU (codec built for it)")
    .add_u64_counter("device_failed",
                     "seam dispatch errors raised to the caller")
    .create_perf_counters())


class _CudaDispatch:
    """Mixin overriding the codec compute seams with device dispatches."""

    plugin_name = "cuda"
    device: torch.device  # set by CudaPlugin.factory before init()

    def _bitmatrix(self, matrix: np.ndarray, on_device: bool,
                   expand: bool = True):
        """`matrix` as a GF(2) bit-matrix, expanded from GF(2^w) when
        `expand`: a host array for the schedule lane, or a tensor on the
        codec's device for the int8-plane lane.  Cached per codec."""
        cache: Dict[Tuple, object] = self.__dict__.setdefault(
            "_bitmatrix_cache", {})
        key = (on_device, matrix.shape, matrix.dtype.str, matrix.tobytes())
        bm = cache.get(key)
        if bm is None:
            bm = matrix_to_bitmatrix(matrix, self.w) if expand else matrix
            if on_device:
                bm = bitmatrix_to_tensor(bm, self.device)
            cache[key] = bm
        return bm

    def _dispatch(self, seam: str, run: Callable[[], np.ndarray]) -> np.ndarray:
        try:
            with span("ec_plugin." + seam):
                if self.device.type == "cpu":
                    out = run()
                    PLUGIN_PERF.inc("cpu_fallback")
                    return out
                with PLUGIN_PERF.time_avg(f"{seam}_s"):
                    out = run()
                PLUGIN_PERF.inc(seam)
                return out
        except Exception as e:
            PLUGIN_PERF.inc("device_failed")
            raise ErasureCodeError(
                -errno.EIO, f"{self.plugin_name} {seam} on {self.device} "
                f"failed: {type(e).__name__}: {e}") from e

    @contextmanager
    def _step(self, step: str) -> Iterator[None]:
        """One step of a dispatch (h2d, launch, d2h): its span, and on the
        card its seconds into the step's ec_plugin average."""
        with span("ec_plugin." + step):
            if self.device.type == "cpu":
                yield
                return
            with PLUGIN_PERF.time_avg(step + "_s"):
                yield

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.uint8))
        return host.to(self.device)

    # seam override: GF(2^w) matrix applied to symbol regions
    def _apply(self, matrix: np.ndarray, regions: np.ndarray) -> np.ndarray:
        def run() -> np.ndarray:
            with self._step("h2d"):
                data = self._to_device(regions)
            with self._step("launch"):
                if packedbit_enabled() and self.w == 8:
                    out = gf2_apply_packedbit(self._bitmatrix(matrix, False),
                                              data)
                else:
                    out = gf2_apply_bytes(self._bitmatrix(matrix, True), data,
                                          self.w, matrix.shape[0])
            with self._step("d2h"):
                return out.cpu().numpy()

        return self._dispatch("apply", run)

    # seam override: GF(2) bit-matrix applied to packet rows
    def _apply_rows(self, bm: np.ndarray, rows: np.ndarray) -> np.ndarray:
        def run() -> np.ndarray:
            w, p = self.w, self.packetsize
            R, nb, _ = rows.shape
            if packedbit_enabled():
                # a packet-row combine is a GF(2) XOR of whole rows: the
                # schedule runs on the packet bytes, with no bit expansion
                with self._step("h2d"):
                    flat = self._to_device(rows.reshape(R, nb * p))
                with self._step("launch"):
                    out = gf2_xor_packed(np.asarray(bm, dtype=np.uint8), flat)
                with self._step("d2h"):
                    return out.cpu().numpy().reshape(bm.shape[0], nb, p)
            n, out_n = R // w, bm.shape[0] // w
            with self._step("h2d"):
                data = self._to_device(rows)
            with self._step("launch"):
                mbits = self._bitmatrix(bm, True, expand=False)
                chunks = (data.reshape(n, w, nb, p)
                          .permute(0, 2, 1, 3).reshape(n, nb * w * p))
                out = (gf2_apply_packets(mbits, chunks, w, p, out_n)
                       .reshape(out_n, nb, w, p).permute(0, 2, 1, 3)
                       .reshape(out_n * w, nb, p))
            with self._step("d2h"):
                return out.cpu().numpy()

        return self._dispatch("apply_rows", run)


class CudaReedSolomonVandermonde(_CudaDispatch, ReedSolomonVandermonde):
    pass


class CudaReedSolomonR6Op(_CudaDispatch, ReedSolomonR6Op):
    pass


class CudaCauchyOrig(_CudaDispatch, CauchyOrig):
    pass


class CudaCauchyGood(_CudaDispatch, CauchyGood):
    pass


class CudaLiberation(_CudaDispatch, Liberation):
    pass


class CudaBlaumRoth(_CudaDispatch, BlaumRoth):
    pass


class CudaLiber8tion(_CudaDispatch, Liber8tion):
    pass


TECHNIQUES = {
    "reed_sol_van": CudaReedSolomonVandermonde,
    "reed_sol_r6_op": CudaReedSolomonR6Op,
    "cauchy_orig": CudaCauchyOrig,
    "cauchy_good": CudaCauchyGood,
    "liberation": CudaLiberation,
    "blaum_roth": CudaBlaumRoth,
    "liber8tion": CudaLiber8tion,
}


class CudaPlugin(ErasureCodePlugin):
    """Builds plugin=cuda codecs on `device`: the current CUDA device by
    default, or whatever resolve_device accepts ("cuda:N", "cpu")."""

    def factory(self, profile: ErasureCodeProfile, device: DeviceLike = None):
        technique = profile.get("technique", "reed_sol_van")
        cls = TECHNIQUES.get(technique)
        if cls is None:
            raise ErasureCodeError(
                -errno.ENOENT,
                f"technique={technique} is not a valid cuda technique "
                f"(have {sorted(TECHNIQUES)})",
            )
        try:
            device = resolve_device(device)
        except (RuntimeError, ValueError) as e:
            raise ErasureCodeError(-errno.ENODEV, str(e)) from e
        codec = cls()
        codec.device = device
        codec.init(dict(profile, technique=technique))
        return codec


def __erasure_code_version__() -> str:
    return PLUGIN_ABI_VERSION


def __erasure_code_init__(name: str, registry) -> int:
    registry.add(name, CudaPlugin())
    return 0
