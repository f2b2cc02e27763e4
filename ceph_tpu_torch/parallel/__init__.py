"""The stripe-batching dispatch queue (copy of ceph_tpu.parallel.service)."""

from ceph_tpu_torch.parallel.service import LANES, BatchingQueue

__all__ = ["LANES", "BatchingQueue"]
