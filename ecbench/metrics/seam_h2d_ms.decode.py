"""seam_h2d_ms.decode: ms a seam dispatch during decodes spends handing its
input to the card (contiguous host copy, from_numpy, .to(device)), from the
program's ec_plugin h2d_s average."""
from ecbench import program_trace, readers

COUNTERS = [readers.PLUGIN]


def read(run):
    return program_trace.step_ms(run, "decode", "h2d")
