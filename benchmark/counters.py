"""The program's LM counters over its newest call of a two-view entry
(spherical_bundle_adjuster_tpu_torch.utils.profiling.LAST_CALL: what the
call added to profiling.COUNTS). In a traced run that call is the one
whose host syncs `host_syncs` counts, the last the run makes before its
readers. A program that keeps no such counters gives None."""

from __future__ import annotations


def lm_counts(field: str):
    """{stage: count} of the counters lm.<stage>.<field> (syncs, active,
    slots) over the newest entry call, or None."""
    from spherical_bundle_adjuster_tpu_torch.utils import profiling

    last = getattr(profiling, "LAST_CALL", None)
    if last is None:
        return None
    return {k.split(".")[1]: v for k, v in last.items()
            if k.startswith("lm.") and k.endswith("." + field)}
