"""lm_syncs.<pair|batch>: host reads of solver.lm's LM loops in one call
of the entry (one a loop trip, summed over every depth, rotation and
translation stage the call solves): the program's counters
lm.<stage>.syncs over the call that host_syncs counts
(benchmark/counters.py). Each is one of host_syncs' syncs."""

from benchmark.counters import lm_counts


def read(ctx):
    syncs = lm_counts("syncs")
    return None if syncs is None else sum(syncs.values())
