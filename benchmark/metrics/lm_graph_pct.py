"""lm_graph_pct.<pair|batch>: the share of solver.lm's LM loop trips in
one call of the entry that ran as the replay of a captured CUDA graph:
100 x the program's counters lm.<stage>.graph_trips over lm.<stage>.syncs,
summed over every stage, over the call that host_syncs counts
(benchmark/counters.py). A loop's first trip runs op by op and its last
host read finds nothing to run, so a solve of k trips reads k - 1 of
k + 1. A program that replays no trip as a graph gives None."""

from benchmark.counters import lm_counts


def read(ctx):
    graphed, syncs = lm_counts("graph_trips"), lm_counts("syncs")
    if not graphed or not syncs or not sum(syncs.values()):
        return None
    return 100.0 * sum(graphed.values()) / sum(syncs.values())
