"""kernel_roofline.encode: the encode ops' frozen byte count at the card's
bandwidth over all kernel time in the trace, %."""
from ecbench import readers


def read(run):
    return readers.kernel_roofline(run, "encode")
