"""seam_ms.decode: ms a seam dispatch (ec/plugins/cuda.py) during decodes."""
from ecbench import readers

COUNTERS = [readers.PLUGIN]


def read(run):
    return readers.seam_ms(run, "decode")
