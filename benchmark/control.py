"""The readings that the limits of `correct` are set from, on the card.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed: the cell's inputs, the program's answers on the judged
sample of pool rows (made as the window makes them: one pair a call, or
the batch calls that cover the rows), the plain reference's answers
(float32, TF32 off), and on --control-seeds the control: the reference
put in the program's place with TF32 on, the nearest precision below
the configuration's float32 with TF32 off. On the same seeds it also
reads rounding alone (the reference a pair at a time against batched)
and two planted faults in the program's place: the refinement returning
its start (every LM solve and the Schur polish of the reference return
their start) and the program's answers with the rotation inverted.
Prints one JSON line a seed with the comparison's numbers for each
(benchmark.reference.compare), and the worst and least of each at the
end. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import generator, run, spec
from .reference import compare, lm
from .system import System, pipeline_config


def worst(per_answer, least=False):
    """The largest reading of each number over the answers (and, with
    `least`, the smallest under the key `<number>.least`)."""
    read = [k for k in compare.NUMBERS if any(k in r for r in per_answer)]
    out = {k: max(r[k] for r in per_answer if k in r) for k in read}
    if least:
        out.update({k + ".least": min(r[k] for r in per_answer if k in r) for k in read})
    return out


@contextlib.contextmanager
def stuck_reference():
    """The reference's refinement returning its start: every LM solve and
    the joint Schur polish hand back the state they were given."""
    saved = lm.lm_fixed, lm.solve_joint_schur

    def stuck_lm(cost_and_system, x0, cfg, max_iters=None, lower_bound=None):
        cost = cost_and_system(x0)[0]
        zero = torch.zeros(cost.shape, dtype=torch.int32, device=cost.device)
        return x0, lm.StageReport(zero, cost, cost)

    def stuck_schur(b1, b2, d0, r0, t0, match_valid, cfg, num_iters=20):
        return r0, t0, d0, torch.zeros(r0.shape[:-1] + (num_iters,), device=r0.device)

    lm.lm_fixed, lm.solve_joint_schur = stuck_lm, stuck_schur
    try:
        yield
    finally:
        lm.lm_fixed, lm.solve_joint_schur = saved


def with_refinement(answer, refined):
    """The answer's front end with another refinement's pose, depths and
    consensus guess."""
    return SimpleNamespace(**{f: getattr(answer, f) for f in
                              ("left_xy", "right_xy", "match_valid", "match_distance")},
                           **vars(refined))


def faults(config, traffic, inputs, judged, chunk):
    """The readings of the two planted faults in the program's place."""
    with stuck_reference():
        stuck = [(rows, with_refinement(a, compare.reference_refine(config, traffic, inputs,
                                                                     rows, a)), pos)
                 for rows, a, pos in judged]
    inverse = [(rows, a._replace(rotation_aa=-a.rotation_aa), pos) for rows, a, pos in judged]
    return {name: worst(compare.judge_calls(config, traffic, inputs, calls, chunk), least=True)
            for name, calls in (("stuck_refinement", stuck), ("inverse_rotation", inverse))}


def witness(config, traffic, inputs, judged):
    """Rounding alone, in float32: the reference's refinement of the judged
    answers' matches a pair at a time against the same refinement over
    all of them as one batch (another batch size rounds the consensus
    stage's products otherwise)."""
    rows = [r for rs, _, pos in judged for r in (rs[j] for j in pos)]
    ans = [a if len(rs) == 1 else compare.row(a, j) for rs, a, pos in judged for j in pos]
    stacked = SimpleNamespace(**{f: np.stack([np.asarray(getattr(a, f)) for a in ans])
                                 for f in ("left_xy", "right_xy", "match_valid")})
    batched = compare.reference_refine(config, traffic, inputs, rows, stacked)
    cfg = compare.reference_config(config, traffic)
    h, w = inputs.lefts.shape[1:3]
    out, ones, bs = [], [], []
    for j, (r, a) in enumerate(zip(rows, ans)):
        one = compare.reference_refine(config, traffic, inputs, [r], a)
        b = compare.row(batched, j)
        ones.append(with_refinement(a, one))
        bs.append(with_refinement(a, b))
        out.append(dict(
            init_gap_deg=compare.angle_deg(compare.euler_matrix(one.initial_euler),
                                           compare.euler_matrix(b.initial_euler)),
            rot_gap_deg=compare.angle_deg(compare.rodrigues(one.rotation_aa),
                                          compare.rodrigues(b.rotation_aa)),
            tran_gap=float(np.linalg.norm(one.translation - b.translation)),
            unsolved_matches=float(max(compare.unsolved(s, cfg.ba) for s in (ones[-1], bs[-1])))))
    line = {k: max(o[k] for o in out) for k in out[0]}
    # the batched refinement in the program's place, judged against the
    # pair-at-a-time one, and the other way round
    for mine, theirs in ((bs, ones), (ones, bs)):
        name, values = compare.refinement_by_cost(cfg, mine, theirs, inputs.lefts.device, w, h)
        line[name] = max(line.get(name, -np.inf), float(np.max(values)))
    return line


def seed_readings(bench, cell, seed, with_control, device):
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    cfg = pipeline_config(config, traffic)
    inputs = generator.make_inputs(config, traffic, cfg.ransac.num_trials, cfg.match.max_matches,
                                   seed, device)
    system = System(config, traffic, inputs, device)
    per_call, pool = config["pairs_per_call"], traffic["pool_pairs"]
    chunk = 0 if per_call == 1 else system.batch_chunk
    n_calls = run.JUDGED_ANSWERS // min(per_call, run.ROWS_PER_CALL)
    t0 = time.perf_counter()
    answers = []
    for k in range(n_calls):
        rows = generator.call_rows(k, per_call, pool)
        answers.append((rows, system.call(rows)))
    t_prog = time.perf_counter() - t0
    del system
    judged = run.judged_sample(answers, seed)
    t0 = time.perf_counter()
    per = compare.judge_calls(config, traffic, inputs, judged, chunk)
    line = {"seed": seed, "program": worst(per),
            "lists_differ": sum(r["lists_differ"] for r in per),
            "program_s": t_prog, "judge_s": time.perf_counter() - t0}
    if with_control:
        ctl = [(rows, compare.control_answer(config, traffic, inputs, rows, chunk), pos)
               for rows, _, pos in judged]
        per = compare.judge_calls(config, traffic, inputs, ctl, chunk)
        line["control_tf32"] = worst(per)
        line["control_lists_differ"] = sum(r["lists_differ"] for r in per)
        line["rounding_witness"] = witness(config, traffic, inputs, judged)
        line.update(faults(config, traffic, inputs, judged, chunk))
        if per_call > 1:  # the front end in passes of one pair: rounding alone again
            per = compare.judge_calls(config, traffic, inputs, judged, 1)
            line["rounding_witness"]["match_unexplained"] = max(r["match_unexplained"] for r in per)
            line["rounding_witness"]["match_dist_gap"] = max(r["match_dist_gap"] for r in per)
    return line


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA device", file=sys.stderr)
        return 2
    run.cache_dirs()
    bench = spec.Spec()
    cell = bench.workload(a.workload)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    lines = []
    for seed in sorted(set(seeds) | ctl):
        line = seed_readings(bench, cell, seed, seed in ctl, torch.device("cuda", 0))
        line["workload"] = cell["name"]
        print(json.dumps(line), flush=True)
        lines.append(line)
    summary = {"workload": cell["name"], "card": run.power_limit()}
    for side in ("program", "control_tf32", "rounding_witness", "stuck_refinement",
                 "inverse_rotation"):
        got = [l[side] for l in lines if side in l]
        keys = sorted({k for g in got for k in g})
        summary[side] = {k: max(g[k] for g in got if k in g) for k in keys}
        summary[side + "_least"] = {k: min(g[k] for g in got if k in g) for k in keys}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
