"""Unpickling of bytes that come from the wire or from a store.

Control frames, BlueStore onodes, KV WAL records, the PG log and the mon's
store are pickles, and a pickle names each class by its module path.  Bytes
written by ceph_tpu name ``ceph_tpu.rados.types`` and the like; the port
must not import ceph_tpu, so its unpickler reads a leading ``ceph_tpu.`` as
``ceph_tpu_torch.``, the port's copy of the same module.  What the port
pickles keeps its own names (a reference daemon cannot read it).
"""

from __future__ import annotations

import io
import pickle

_REFERENCE = "ceph_tpu"
_PORT = "ceph_tpu_torch"


class Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if module == _REFERENCE or module.startswith(_REFERENCE + "."):
            module = _PORT + module[len(_REFERENCE):]
        return super().find_class(module, name)


def loads(data) -> object:
    """pickle.loads with the reference's class paths mapped to the port's."""
    return Unpickler(io.BytesIO(data)).load()


def load(f) -> object:
    """pickle.load from a binary file, with the same mapping."""
    return Unpickler(f).load()
