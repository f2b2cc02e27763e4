"""op_p99_ms.host.decode: the 99th percentile of the latency of every decode op
in the window, at the codec entry, ms.  Host-paced: the device is idle most
of the window, so this tail is the host's."""
from ecbench import readers


def read(run):
    if run.family != "decode":
        return None
    return readers.percentile_ms(run, 99)
