"""select_ms.decode: ms a decode spends choosing its survivors and their
decode matrix (ec/codecs.py decode selection, the decode-matrix cache), from
the program's spans."""
from ecbench import program_trace

COUNTERS = [program_trace.SET]


def read(run):
    return program_trace.ms_an_op(run, "decode", "ec.decode_select")
