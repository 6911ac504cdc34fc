"""lm_active_pct.<pair|batch>: the share of the lockstep LM loops'
element-iterations spent on problems whose result is kept, in one call
of the entry: 100 x the kept problems still active at each loop trip
over the problems in the batch at each trip, summed over every trip of
every stage (the program's counters lm.<stage>.active and
lm.<stage>.slots over the call that host_syncs counts,
benchmark/counters.py). A batch's loop runs until its slowest problem
stops, and a depth stage iterates its padded and invalid match slots
too: the rest is the batch's waste."""

from benchmark.counters import lm_counts


def read(ctx):
    active, slots = lm_counts("active"), lm_counts("slots")
    if active is None or not sum(slots.values()):
        return None
    return 100.0 * sum(active.values()) / sum(slots.values())
