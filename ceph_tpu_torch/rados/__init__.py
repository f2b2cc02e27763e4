"""The OSD's EC data path below the daemon: ecutil's stripe plans and the
messenger's BufferList (copies of ceph_tpu.rados modules)."""
