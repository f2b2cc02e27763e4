"""copy_ms.encode: device ms of host-to-device and device-to-host copies
a encode op, from the trace."""
from ecbench import readers


def read(run):
    return readers.copy_ms(run, "encode")
