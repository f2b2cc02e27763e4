"""encode_GBps: object bytes written over the whole window, GB/s."""
from ecbench import readers


def read(run):
    return readers.object_GBps(run, "encode")
