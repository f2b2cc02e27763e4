"""op_p99_ms.host.encode: the 99th percentile of the latency of every encode op
in the window, at the codec entry, ms.  Host-paced: the device is idle most
of the window, so this tail is the host's."""
from ecbench import readers


def read(run):
    if run.family != "encode":
        return None
    return readers.percentile_ms(run, 99)
