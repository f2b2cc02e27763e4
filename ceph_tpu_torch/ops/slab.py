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
- ``PageTable`` is one resident's pages as the page-addressed kernels of
  ops/cuda_packedbit.py take them (and, on CUDA, their addresses on the
  card); ``gather_words`` and ``install_pages`` are the slab ops over one.

These are torch ops, not kernels: the reference's are XLA scatter/take, no
Pallas.  Torch compiles nothing per geometry and has no buffer donation, so
the reference's row-count bucketing, donation switch, prewarm and its
``slab_kernels`` LRU counters have no counterpart here.

Both run on the current stream.  On CUDA the row indices cross to the card
through pinned memory with a non-blocking copy, so an install or gather
never waits for the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

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


class PageTable:
    """One resident's pages: page i is row ``pages[i] & mask`` of sub-slab
    ``pages[i] >> shift`` (``slabs`` holds every sub-slab it touches), and
    the resident's words run through them in order, ``page_words`` a page.
    On CUDA ``addr`` holds each page's address on the card (int64), built
    once: sub-slabs are never moved or freed and a resident's pages never
    move, so the table holds for the resident's life.  Its host->device
    copy runs on the current stream, so build it inside the store's slab
    operation bracket."""

    def __init__(self, pages: Sequence[int], slabs: Dict[int, torch.Tensor],
                 page_words: int, shift: int):
        self.pages = tuple(int(p) for p in pages)
        self.slabs = slabs
        self.page_words = int(page_words)
        self.shift = int(shift)
        self.device = next(iter(slabs.values())).device
        self.addr: Optional[torch.Tensor] = None
        if self.device.type == "cuda":
            mask, page_bytes = (1 << shift) - 1, 4 * self.page_words
            host = torch.tensor([slabs[p >> shift].data_ptr()
                                 + (p & mask) * page_bytes
                                 for p in self.pages], dtype=torch.int64)
            self.addr = host.pin_memory().to(self.device, non_blocking=True)

    def runs(self, p0: int, p1: int):
        """(sub-slab, row indices) of pages p0..p1-1, one a run of pages in
        the same sub-slab, in page order."""
        mask = (1 << self.shift) - 1
        i = p0
        while i < p1:
            s = self.pages[i] >> self.shift
            idx = []
            while i < p1 and (self.pages[i] >> self.shift) == s:
                idx.append(self.pages[i] & mask)
                i += 1
            yield self.slabs[s], idx


def gather_words(table: PageTable, w0: int, n: int) -> torch.Tensor:
    """Words w0 .. w0+n-1 of the resident as a fresh int32 tensor: one
    slab_gather for each run of its pages in one sub-slab, concatenated and
    sliced."""
    pw = table.page_words
    p0, p1 = w0 // pw, -(-(w0 + n) // pw)
    parts = [slab_gather(slab, idx) for slab, idx in table.runs(p0, p1)]
    block = parts[0] if len(parts) == 1 else torch.cat(parts)
    start = w0 - p0 * pw
    return block.view(-1)[start:start + n]


def install_pages(table: PageTable, image: torch.Tensor) -> None:
    """Write [len(pages), page_words] int32 page rows into the resident's
    pages: one slab_install for each sub-slab it touches."""
    groups: Dict[int, list] = {}
    for i, pid in enumerate(table.pages):
        groups.setdefault(pid >> table.shift, []).append(i)
    mask = (1 << table.shift) - 1
    for s, order in groups.items():
        idx = np.array([table.pages[i] & mask for i in order], dtype=np.int64)
        data = (image if len(order) == len(table.pages)
                else slab_gather(image, order))
        slab_install(table.slabs[s], data, idx)
