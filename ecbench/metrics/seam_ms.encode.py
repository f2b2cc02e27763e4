"""seam_ms.encode: ms a seam dispatch (ec/plugins/cuda.py) during encodes."""
from ecbench import readers

COUNTERS = [readers.PLUGIN]


def read(run):
    return readers.seam_ms(run, "encode")
