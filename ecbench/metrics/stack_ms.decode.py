"""stack_ms.decode: ms a decode spends stacking the chosen survivors
(ec/codecs.py decode_chunks), from the program's spans."""
from ecbench import program_trace

COUNTERS = [program_trace.SET]


def read(run):
    return program_trace.ms_an_op(run, "decode", "ec.stack_survivors")
