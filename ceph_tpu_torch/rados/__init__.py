"""Mini-RADOS on the port: the in-process cluster (mon, OSDs, client,
vstart), its messenger and stores, and the OSD's EC data path (ecutil's
stripe plans, the paged resident store) — copies of ceph_tpu.rados modules
with their imports rebound, and the device seams on torch."""

#: why the port has no mgr: raised by ``vstart.Cluster(with_mgr=True)``
MGR_NOT_IN_PORT = ("the mgr daemon is not in ceph_tpu_torch yet: it is "
                   "ported after the port's bench (ROADMAP.md, modules "
                   "still to port)")

#: logged once by a daemon whose conf names a mgr (``mgr_addr``)
MGR_NOT_PORTED = ("mgr_addr is set, but " + MGR_NOT_IN_PORT
                  + "; this daemon sends no MMgrReport")
