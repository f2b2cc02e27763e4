# Copy of ceph_tpu/mgr/__init__.py at commit 484e351, with its ceph_tpu
# import statements rebound to ceph_tpu_torch.
"""Management plane (reference src/mgr/, src/pybind/mgr/): the mgr daemon
aggregates per-daemon perf reports and serves them to operators — the
prometheus exporter module and the crash module in miniature."""
