"""Mini-RADOS on the port: the in-process cluster (mon, OSDs, client,
vstart), its messenger and stores, and the OSD's EC data path (ecutil's
stripe plans, the paged resident store) — copies of ceph_tpu.rados modules
with their imports rebound, and the device seams on torch."""

