"""relayout_ms.encode: ms an encode spends in the packet re-layout
(ec/codecs.py _to_rows and _from_rows), from the program's spans."""
from ecbench import program_trace

COUNTERS = [program_trace.SET]


def read(run):
    return program_trace.ms_an_op(run, "encode", "ec.to_rows", "ec.from_rows")
