"""Service layers over RADOS (reference src/librbd/, src/cls/, src/rgw/,
src/mds/), each a thin consumer of the librados facade: in-OSD object
classes (``cls``), block images and their export streams (``rbd``,
``rbd_export``), the object gateway with its S3/Swift HTTP frontend
(``rgw``), and the file namespace with its cap-aware clients (``mds``) and
multi-active ranks (``mds_cluster``).  Only ``cls`` runs inside the OSD;
the rest pick no device: their EC work is the OSDs'."""
