"""Page-slab installs and gathers for the paged resident store's device arm
(ceph_tpu_torch/rados/pagestore.py).

Counterpart of ceph_tpu/ops/slab.py.  Each lazily committed sub-slab is a
[256, page_words] int32 tensor (the words carry the reference's uint32
bits: torch has no ``index_copy_`` for uint32), and a resident's pages are
rows of those tensors:

- ``slab_install(slab, data, idx)`` writes [n, page_words] page rows into
  the sub-slab at row indices ``idx``, in place (``index_copy_``).
- ``slab_gather(slab, idx)`` reads rows back as a fresh tensor
  (``index_select``, never a view), so a gather that raced a later install
  still holds the bytes it read.

These are torch ops, not kernels: the reference's are XLA scatter/take, no
Pallas.  Torch compiles nothing per geometry and has no buffer donation, so
the reference's row-count bucketing, donation switch, prewarm and its
``slab_kernels`` LRU counters have no counterpart here.

Both run on the current stream.  On CUDA the row indices cross to the card
through pinned memory with a non-blocking copy, so an install or gather
never waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _index(idx, device: torch.device) -> torch.Tensor:
    """Host row indices as an int64 tensor on `device`."""
    host = torch.from_numpy(np.asarray(idx, dtype=np.int64))
    if device.type == "cpu":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def slab_install(slab: torch.Tensor, data: torch.Tensor, idx) -> None:
    """Write [n, page_words] int32 page rows into the sub-slab at row
    indices ``idx`` (a host integer array), in place.  ``data`` is only read:
    it may alias a shared batch product of the queue."""
    if data.dtype != slab.dtype or data.shape[1:] != slab.shape[1:]:
        raise ValueError(f"slab_install: {tuple(data.shape)} {data.dtype} rows "
                         f"into a {tuple(slab.shape)} {slab.dtype} sub-slab")
    slab.index_copy_(0, _index(idx, slab.device), data)


def slab_gather(slab: torch.Tensor, idx) -> torch.Tensor:
    """Rows ``idx`` of the sub-slab as a fresh [n, page_words] tensor."""
    return torch.index_select(slab, 0, _index(idx, slab.device))


def new_subslab(n_pages: int, page_words: int,
                device: torch.device) -> torch.Tensor:
    """A zeroed sub-slab.  Zeroing costs one fill but makes the ragged
    install tail well defined: a whole-page gather never reads memory
    nothing wrote."""
    return torch.zeros((n_pages, page_words), dtype=torch.int32,
                       device=device)


def is_device_array(x, device: torch.device) -> bool:
    """True for a tensor on the store's device: a queue-produced resident
    installs without a bounce through host memory."""
    return isinstance(x, torch.Tensor) and x.device == device
