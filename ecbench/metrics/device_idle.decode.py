"""device_idle.decode: share of the traced window with nothing on the card,
%."""
from ecbench import readers


def read(run):
    return readers.device_idle(run, "decode")
