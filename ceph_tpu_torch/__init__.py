"""ceph_tpu_torch — the erasure-coding data path of ceph_tpu on PyTorch and CUDA.

A second package beside ``ceph_tpu`` with the same layout and names, so each
module's counterpart is found at the same path.  It imports ``torch`` and never
``jax``, and nothing of ``ceph_tpu``: the host modules it needs (the codec
interface, GF(2^w) oracle, matrix constructions, registry, perf counters) are
its own copies.  The device work is the bit-plane GF(2) matmul of
``ceph_tpu/ops/pallas_gf2.py``, here as CUDA C++ kernels written for Hopper
(``ceph_tpu_torch/ops/csrc/gf2.cu``), registered as ``plugin=cuda``.

Layout:
  ceph_tpu_torch.ec        codec interface, registry, GF math, jerasure + cuda plugins
  ceph_tpu_torch.ops       bit-plane GF(2) lanes (gf2.py), slab ops and their CUDA kernels
  ceph_tpu_torch.parallel  the stripe-batching queue and PlanarShardStore
  ceph_tpu_torch.rados     mini-RADOS: mon, OSD, client, vstart, messenger, stores,
                           ecutil and the paged resident store
  ceph_tpu_torch.services  object classes (cls)
  ceph_tpu_torch.tools     ceph_erasure_code_benchmark-style CLI, walk_split
  ceph_tpu_torch.utils     device resolution, checksum (crc32c), wirepath
  ceph_tpu_torch.common    config, context, logging, admin socket, tracing,
                           op tracking, throttles, perf counters

Entry points run on the CUDA device unless the caller names the CPU.
"""

__version__ = "0.1.0"

# Plugin ABI version handshake, as in ceph_tpu: a plugin module reporting a
# different version is refused by the registry with -EXDEV.
PLUGIN_ABI_VERSION = __version__
