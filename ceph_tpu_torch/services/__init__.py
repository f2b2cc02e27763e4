"""Service layers over RADOS (reference src/librbd/, src/cls/, src/rgw/,
src/mds/): block images, in-OSD object classes, object gateway, and a
file namespace — each a thin, idiomatic consumer of the librados facade."""
