"""sched_misses.decode: schedule LRU misses (ops/gf2.py gf2_sched) per
1000 degraded reads in the window."""
from ecbench import readers

COUNTERS = [readers.SCHED]


def read(run):
    c = run.counters.get("gf2_sched")
    if run.family != "decode" or c is None or run.ops == 0:
        return None
    return c["miss"] / run.ops * 1000
