"""decode_GBps: object bytes returned by degraded reads over the whole
window, GB/s."""
from ecbench import readers


def read(run):
    return readers.object_GBps(run, "decode")
