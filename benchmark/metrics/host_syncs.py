"""host_syncs.<pair|batch>: host syncs in one call of the entry (a pair,
or a batch), counted by torch's sync debug mode over a call outside the
window (layer models.twoview). Each is a read of a card value on the
host or a blocking copy; the LM loop makes one an iteration."""


def read(ctx):
    return ctx["counters"].get("host_syncs")
