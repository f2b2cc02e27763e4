"""In-tree erasure-code plugins, one module per plugin name (resolved by
ceph_tpu_torch.ec.registry): jerasure, isa, shec, lrc, clay and cuda, plus the
xor example codec used by tests."""
