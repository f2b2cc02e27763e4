"""codec_host_ms.encode: host ms a encode op spends in the codec (ec/base.py,
ec/codecs.py) outside its seam."""
from ecbench import readers


def read(run):
    return readers.codec_host_ms(run, "encode")
