"""codec_host_ms.decode: host ms a decode op spends in the codec (ec/base.py,
ec/codecs.py) outside its seam."""
from ecbench import readers


def read(run):
    return readers.codec_host_ms(run, "decode")
