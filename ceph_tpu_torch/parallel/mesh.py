"""Device-mesh execution for the batching queue: one dispatch laid across
several CUDA devices.

Counterpart of ceph_tpu/parallel/mesh.py at commit d2d1706, on PyTorch.
The EC workload has two decomposition axes:

  * ``stripe``: data parallelism over independent stripes;
  * ``col``: sub-chunk parallelism across the byte columns of a stripe.

The BatchingQueue flattens stripes into the column axis of one
``[rows, sum(B)]`` batch, so splitting that column axis over both mesh axes
spreads every stripe and sub-chunk over every device.  The GF(2) product
contracts over rows (the bit-planes), which each device holds whole, so a
dispatch is embarrassingly parallel: no collectives on the hot path.  Each
shard runs the lane's own kernel on its device, and the queue gathers the
shards' products in column order.

The reference builds a ``jax.sharding.Mesh`` and lets XLA place the shards
(``column_sharding``, ``replicated``); torch has neither, so the dispatcher
gives the queue what it needs instead: the column bounds of a width
(``column_bounds``) and a batch split into shards on their devices
(``shard_batch``).  The bit-matrix every shard reads whole is placed once on
each device by the queue's own cache of device bit-matrices.

Engagement, ``shared_mesh(device)``: over every visible CUDA device when the
queue's device is a card and there are two or more; under ``CEPH_TPU_MESH=1``
over ``FORCED_SHARDS`` (8) shards of the queue's own device when fewer than
two cards are visible (the counterpart of the reference's forced mesh over
an 8-device virtual CPU backend: on one card the shards are column views of
one batch, each its own launch; on the CPU, when the caller named it, as the
tests do); otherwise None, and a single-device queue pays nothing.  A mesh
that was asked for and cannot be built raises; the reference remembers the
failure and serves on one device.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ceph_tpu_torch.utils.cudadev import DeviceLike, resolve_device

#: shards of one device in a forced mesh (the reference's 8 virtual devices)
FORCED_SHARDS = 8

_MESH_LOCK = threading.Lock()
_SHARED: Dict[Tuple[str, int], "MeshDispatcher"] = {}


def _factor_axes(n: int) -> Tuple[int, int]:
    """n devices -> (stripe, col) axis sizes, e.g. 8 -> (2, 4)."""
    col = 1
    for cand in (2, 4):
        if n % cand == 0:
            col = cand
    return n // col, col


class MeshDispatcher:
    """A (stripe, col) grid of torch devices and the operations the batching
    queue needs to lay a batch's column axis across it.  `devices` may name
    one device several times (shards of one card).  One process-wide
    dispatcher keeps one layout."""

    axis_names = ("stripe", "col")

    def __init__(self, devices: Sequence[DeviceLike]):
        if len(devices) < 2:
            raise ValueError("a mesh needs >= 2 devices")
        self.devices: List[torch.device] = [resolve_device(d)
                                            for d in devices]
        stripe, col = _factor_axes(len(self.devices))
        self.n_devices = len(self.devices)
        self.mesh = np.empty(self.n_devices, dtype=object)
        self.mesh[:] = self.devices
        self.mesh = self.mesh.reshape(stripe, col)
        #: the distinct devices, in mesh order
        self.unique_devices: List[torch.device] = list(
            dict.fromkeys(self.devices))
        self.shard_puts = 0  # batches laid out across the mesh

    def pad_cols(self, n_cols: int) -> int:
        """Columns must split evenly across the device grid."""
        n = self.n_devices
        return -(-n_cols // n) * n

    def column_bounds(self, n_cols: int) -> List[Tuple[int, int]]:
        """Each device's [c0, c1) of a width that splits evenly (pad_cols),
        contiguous and in device order."""
        if n_cols % self.n_devices:
            raise ValueError(f"{n_cols} columns do not split over "
                             f"{self.n_devices} devices")
        w = n_cols // self.n_devices
        return [(i * w, (i + 1) * w) for i in range(self.n_devices)]

    def shard_batch(self, batch: torch.Tensor):
        """Split [.., cols] along its last axis into n_devices contiguous
        column shards, in device order, each on its device: a view when the
        batch is already on that device, else a non-blocking copy (issued
        on the current streams of both devices).  Returns [(shard, (c0,
        c1)), ...]."""
        self.shard_puts += 1
        out = []
        for dev, (c0, c1) in zip(self.devices,
                                 self.column_bounds(batch.shape[-1])):
            part = batch[..., c0:c1]
            if part.device != dev:
                part = part.contiguous().to(dev, non_blocking=True)
            out.append((part, (c0, c1)))
        return out


def shared_mesh(device: DeviceLike = None) -> Optional[MeshDispatcher]:
    """The process mesh for a queue on `device`, or None when multi-device
    execution should not engage (one card and no CEPH_TPU_MESH=1, or a CPU
    queue without it).  Raises when a mesh is asked for and cannot be
    built."""
    dev = resolve_device(device)
    forced = os.environ.get("CEPH_TPU_MESH") == "1"
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards < 2 and not forced:
        return None
    key = (str(dev), cards)
    with _MESH_LOCK:
        mesh = _SHARED.get(key)
        if mesh is None:
            pool = ([torch.device("cuda", i) for i in range(cards)]
                    if cards >= 2 else [dev] * FORCED_SHARDS)
            mesh = _SHARED[key] = MeshDispatcher(pool)
        return mesh
