"""The system under test: spherical_bundle_adjuster_tpu_torch's two-view
entry points, driven as the reference tool's users call them.

A call is `models.twoview.run_two_view` on one pool pair
(pairs_per_call 1) or `run_two_view_batch` on pairs_per_call pool pairs,
with the benchmark's draws, followed by the one copy of its result off
the card (`utils.tree.to_host`): the CLI's `bundle_adjustment` span.
`batch_chunk` stays the program's default. The probes time the two
halves of the same entry from outside (front end; refinement) and count
a call's host syncs; the program has no spans inside its entry yet.
"""

from __future__ import annotations

import contextlib
import inspect
import warnings

import torch

from .reference import compare


def pipeline_config(config: dict, traffic: dict):
    """The program's PipelineConfig: every field the configuration's file
    gives, then the traffic's per-call `request` fields."""
    from spherical_bundle_adjuster_tpu_torch.utils import config as classes

    return compare.config_from_files(classes, config, traffic)


class System:
    """The program on the cell's inputs (generator.Inputs)."""

    def __init__(self, config: dict, traffic: dict, inputs, device):
        from spherical_bundle_adjuster_tpu_torch.models import frontend, twoview
        from spherical_bundle_adjuster_tpu_torch.utils import tree

        self.config, self.traffic = config, traffic
        self.cfg = pipeline_config(config, traffic)
        self.inputs = inputs
        self.device = device
        self.per_call = config["pairs_per_call"]
        self.frontend_name = config["frontend"]
        self._twoview, self._frontend, self._tree = twoview, frontend, tree
        self.batch_chunk = inspect.signature(
            twoview.run_two_view_batch).parameters["batch_chunk"].default

    def run(self, rows):
        """The entry on pool rows `rows`, on the device (no copy off it)."""
        inp = self.inputs
        if self.per_call == 1:
            (i,) = rows
            return self._twoview.run_two_view(inp.lefts[i], inp.rights[i], None, self.cfg,
                                              frontend=self.frontend_name, gumbel=inp.gumbel[i])
        idx = torch.as_tensor(rows, device=self.device)
        lefts, rights = inp.lefts[rows[0]:rows[-1] + 1], inp.rights[rows[0]:rows[-1] + 1]
        if lefts.shape[0] != len(rows):  # the call wraps round the pool
            lefts, rights = inp.lefts[idx], inp.rights[idx]
        return self._twoview.run_two_view_batch(lefts, rights, None, self.cfg,
                                                frontend=self.frontend_name,
                                                gumbel=inp.gumbel[idx])

    def call(self, rows):
        """One call as a user makes it: the entry, then its result on the
        host (numpy leaves, a leading pair axis when pairs_per_call > 1)."""
        return self._tree.to_host(self.run(rows))

    # -- probes: the entry's halves timed from outside, and its host syncs

    def frontend(self, rows):
        """The front end the entry runs, on the same pairs."""
        inp = self.inputs
        idx = torch.as_tensor(rows, device=self.device)
        chunk = 0 if self.per_call == 1 else self.batch_chunk
        return self._frontend.frontend_pairs(self.frontend_name, inp.lefts[idx],
                                             inp.rights[idx], self.cfg, chunk)

    def refine(self, fr, rows):
        """The refinement the entry runs (lift, consensus, BCD, ...) on the
        front end's matches and the same draws."""
        h, w = self.inputs.lefts.shape[1:3]
        if self.per_call == 1:  # run_two_view's unbatched shapes
            fr = type(fr)(*(f[0] for f in fr))
            gumbel = self.inputs.gumbel[rows[0]]
        else:
            gumbel = self.inputs.gumbel[torch.as_tensor(rows, device=self.device)]
        b_left, b_right = self._twoview.lift_matches(fr, w, h)
        return self._twoview.adjust_from_matches(b_left, b_right, fr.match_valid, None,
                                                 self.cfg, gumbel=gumbel)


@contextlib.contextmanager
def sync_counter():
    """Yields a list that holds, on exit, the number of host syncs made
    inside, as torch's sync debug mode warns of them (each blocking copy
    between host and card, and each read of a card value on the host)."""
    count = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield count
        finally:
            torch.cuda.set_sync_debug_mode("default")
    count.append(sum("called a synchronizing CUDA operation" in str(w.message) for w in caught))
