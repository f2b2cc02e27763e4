"""The port's page-slab ops against ceph_tpu.ops.slab on the same seeded
inputs: installs at ragged row counts (the reference pads them to pow2
buckets, the port does not), gathers with repeated rows, and a gather that
outlives a later install.  Sub-slabs are compared as bytes (int32 words
here, uint32 in the reference)."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import slab as ref
from ceph_tpu_torch.ops.slab import (is_device_array, new_subslab,
                                     slab_gather, slab_install)

PAGES, WORDS = 256, 64
CPU = torch.device("cpu")


@pytest.mark.parametrize("n", [1, 3, 17, 256])
def test_install_and_gather_match_reference(n):
    rng = np.random.default_rng(n)
    idx = rng.permutation(PAGES)[:n].astype(np.int32)
    data = rng.integers(0, 2**32, (n, WORDS), dtype=np.uint32)
    theirs = ref.slab_install(ref.new_subslab(PAGES, WORDS), data, idx)
    mine = new_subslab(PAGES, WORDS, CPU)
    slab_install(mine, torch.from_numpy(data.view(np.int32)), idx)
    np.testing.assert_array_equal(mine.numpy().view(np.uint32),
                                  np.asarray(theirs))
    # a gather with repeats and rows nothing wrote (zero)
    take = rng.integers(0, PAGES, n + 2).astype(np.int32)
    got = slab_gather(mine, take)
    assert got.shape == (n + 2, WORDS) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref.slab_gather(theirs, take)))


def test_gather_is_fresh_and_survives_a_later_install():
    slab = new_subslab(PAGES, WORDS, CPU)
    first = torch.arange(2 * WORDS, dtype=torch.int32).view(2, WORDS)
    slab_install(slab, first, [5, 9])
    got = slab_gather(slab, [9, 5])
    assert got.untyped_storage().data_ptr() != slab.untyped_storage().data_ptr()
    slab_install(slab, torch.full((2, WORDS), -1, dtype=torch.int32), [5, 9])
    assert torch.equal(got, first.flip(0))
    assert torch.equal(slab_gather(slab, [5]), torch.full((1, WORDS), -1,
                                                          dtype=torch.int32))


def test_new_subslab_is_zeroed_int32_and_installs_check_rows():
    slab = new_subslab(8, 16, CPU)
    assert slab.shape == (8, 16) and slab.dtype == torch.int32
    assert not slab.any()
    with pytest.raises(ValueError, match="slab_install"):
        slab_install(slab, torch.zeros((1, 16), dtype=torch.uint8), [0])
    with pytest.raises(ValueError, match="slab_install"):
        slab_install(slab, torch.zeros((1, 15), dtype=torch.int32), [0])


def test_is_device_array_is_a_tensor_on_the_stores_device():
    assert is_device_array(torch.zeros(2), CPU)
    assert not is_device_array(np.zeros(2), CPU)
    assert not is_device_array(torch.zeros(2, device="meta"), CPU)
