"""seam_d2h_ms.encode: ms a seam dispatch during encodes spends waiting for
the kernel and copying its output back (out.cpu().numpy()), from the
program's ec_plugin d2h_s average."""
from ecbench import program_trace, readers

COUNTERS = [readers.PLUGIN]


def read(run):
    return program_trace.step_ms(run, "encode", "d2h")
