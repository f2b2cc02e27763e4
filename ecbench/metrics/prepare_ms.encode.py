"""prepare_ms.encode: ms an encode spends in encode_prepare (ec/base.py:
the zero-fill and copy into k chunks), from the program's spans."""
from ecbench import program_trace

COUNTERS = [program_trace.SET]


def read(run):
    return program_trace.ms_an_op(run, "encode", "ec.encode_prepare")
