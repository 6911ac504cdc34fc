"""lm_kernel_pct.<pair|batch>: the share of solver.lm's LM loop trips in
one call of the entry that ran through the program's trip kernels
(ops/cuda_lm): 100 x the program's counters lm.<stage>.kernel_trips over
lm.<stage>.syncs, summed over every stage, over the call that host_syncs
counts (benchmark/counters.py). A loop's last host read finds nothing to
run, so a solve of k trips reads k of k + 1. A program that runs no
trip as the kernel gives None."""

from benchmark.counters import lm_counts


def read(ctx):
    trips, syncs = lm_counts("kernel_trips"), lm_counts("syncs")
    if not trips or not syncs or not sum(syncs.values()):
        return None
    return 100.0 * sum(trips.values()) / sum(syncs.values())
