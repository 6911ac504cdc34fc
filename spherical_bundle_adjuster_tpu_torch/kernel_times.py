"""Time the port's kernels K1, K2 and K3 on the card at the 2K slice's
shapes, or its global solves, for this tree or another checkout of the port.

    python spherical_bundle_adjuster_tpu_torch/kernel_times.py [--tree DIR] [--label NAME]
    python spherical_bundle_adjuster_tpu_torch/kernel_times.py --stage-bytes 73728,114688
    python spherical_bundle_adjuster_tpu_torch/kernel_times.py --ablate
    python spherical_bundle_adjuster_tpu_torch/kernel_times.py --save-solves P.pt
    python spherical_bundle_adjuster_tpu_torch/kernel_times.py --solves P.pt [--tree DIR] [--label NAME]
        [--against DIR2]
    python spherical_bundle_adjuster_tpu_torch/kernel_times.py --lm [--tree DIR] [--label NAME]

`--tree` imports spherical_bundle_adjuster_tpu_torch from DIR instead of
this checkout (for example an older commit unpacked with `git archive`),
so two versions of the kernels are timed on the same inputs. DIR's
utils/profiling supplies the timer (device_ms) and its problems.py the
problems of `--lm` and `--save-solves`, so DIR must hold both. Each line of
output is one JSON object: the kernel, its device time per call
(`device_ms`: CUDA events around back-to-back calls queued behind a GPU
spin, so host overhead does not count), its wall time per call with the
host in the loop (`wall_ms`), a digest of its outputs' bytes
(`out_sha`: equal digests from two trees mean bit-identical outputs on
the same inputs), and the card's name and power limit. Needs one NVIDIA
GPU.

For this tree only: `--stage-bytes` times K1 and K2 under other
shared-memory staging budgets (ops/cuda_surf.STAGE_BYTES), and
`--ablate` also times the kernels built without their shared-memory
copies (SBA_NO_STAGE) and without their compute (SBA_NO_COMPUTE), which
splits their time between staging and compute. For K3 it also times
one query tile alone (`top2_one_tile`: 128 queries, one block per SM)
and K3 built without the merge of the blocks' top-2 (SBA_NO_MERGE).
Those lines carry the budget and the variant.

`--save-solves` builds the solver and tracks problems of problems.py
with the tree (on the CPU) and saves them. `--solves` loads them and times each
with DIR's solve_multiview or optimize_pose_graph instead of the
kernels; `--against DIR2` times DIR2's too, in the same process, the
two versions' solves in turns, so that both see the same host load.
One line per problem and version: the median of 3 solves (8 with
`--against`) after a warm-up (CUDA events around the call, the host in
the loop), the median of their process CPU times (`host_cpu_ms`), the
final cost and a digest of the solved poses, landmarks and costs.

`--lm` times one trip of each LM stage (solver/lm), in compat and
corrected mode, at the benchmark cells' shapes (problems.LM_SHAPES: a
2K pair's 1024 matches alone and with 4 starts, a 64-pair batch's 512
with 1 and 4 starts) on the tests' stage problem
(problems.stage_problem), from its start with every problem active: the
trip kernels (`trip_kernel`, ops/cuda_lm) and the trip op by op
(`trip_ops`, lm._trip). Each kernel line carries the bytes the trip must
move (`bytes`, each input read once and each output written once) and
its bound at 3.35 TB/s (`bound_ms`). It times a tree with the trip
kernels only.
"""

from __future__ import annotations

import hashlib
import time

import torch


def digest(out):
    """sha256 (first 16 hex digits) of the bytes of a tensor or of a
    nested tuple or list of tensors."""
    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, (tuple, list)):
            for y in x:
                feed(y)
        else:
            h.update(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())

    feed(out)
    return h.hexdigest()[:16]


def save_solves(path):
    """The solver and tracks problems of problems.py, built on the CPU:
    {name: (kind, fields, solve keywords)}."""
    from spherical_bundle_adjuster_tpu_torch import problems
    from spherical_bundle_adjuster_tpu_torch.models import multiview, tracks
    from spherical_bundle_adjuster_tpu_torch.solver import pose_graph

    out = {}
    for name, C, L, P, noise, seed, kw in problems.MULTIVIEW_PHASES:
        fields, _ = problems.synth_multiview(C, L, P, noise, seed)
        out[name] = ("multiview", list(multiview.problem_from_numpy(fields, "cpu")), kw)
    for name, n, k, seed, kw in problems.POSE_GRAPH_PHASES:
        fields, _ = problems.synth_pose_graph(n, k, seed)
        out[name] = ("pose_graph", list(pose_graph.graph_from_numpy(fields, "cpu")), kw)
    for name, C, n_lm, slots, stride, kw in problems.TRACKS_PHASES:
        fields, _ = problems.synth_tracks(C, n_lm, problems.TRACKS_SEED, window=slots,
                                          stride=stride, slots=slots)
        prob = tracks.build_multiview_problem(*(torch.as_tensor(a) for a in fields),
                                              problems.TRACKS_W, problems.TRACKS_H,
                                              max_obs_per_track=problems.TRACKS_P)
        out[name] = ("multiview", list(prob), kw)
    torch.save(out, path)


def load_port(tree, alias):
    """The port of the checkout at tree, imported as package `alias`, so
    that two versions run in one process (the port imports itself only
    by relative imports)."""
    import importlib.util
    import sys

    pkg = tree / "spherical_bundle_adjuster_tpu_torch"
    spec = importlib.util.spec_from_file_location(alias, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return alias


def time_solves(path, ports, card):
    """Times each saved problem's solve with each port, (label, package
    name) pairs: a warm-up each, then 3 solves, or with two ports 8 in
    turns (AB BA AB BA ...), so both see the same host load."""
    import importlib
    import json
    import statistics

    dev = torch.device("cuda", 0)
    mods = [(label, importlib.import_module(f"{pkg}.models.multiview"),
             importlib.import_module(f"{pkg}.solver.pose_graph")) for label, pkg in ports]
    reps = 3 if len(mods) == 1 else 8
    for name, (kind, fields, kw) in torch.load(path).items():
        fields = [f.to(dev) for f in fields]
        runs = []
        for label, multiview, pose_graph in mods:
            if kind == "multiview":
                inputs, solve = multiview.MultiViewProblem(*fields), multiview.solve_multiview
            else:
                inputs, solve = pose_graph.PoseGraph(*fields), pose_graph.optimize_pose_graph
            solve(inputs, **kw)  # warm-up
            runs.append((label, inputs, solve, [], []))
        for r in range(reps):
            for label, inputs, solve, times, cpu in (runs if r % 2 == 0 else runs[::-1]):
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                torch.cuda.synchronize()
                c0 = time.process_time()
                start.record()
                solved, costs = solve(inputs, **kw)
                end.record()
                torch.cuda.synchronize()
                cpu.append((time.process_time() - c0) * 1e3)
                times.append(start.elapsed_time(end))
                parts = (solved.poses, solved.landmarks, costs) if kind == "multiview" else (
                    solved.poses, costs)
                if len(times) == reps:
                    print(json.dumps({
                        "tree": label, "solve": name, "solve_ms": statistics.median(times),
                        "solve_ms_each": times, "host_cpu_ms": statistics.median(cpu),
                        "final_cost": float(costs[-1]), "out_sha": digest(parts),
                        "card": card}), flush=True)


HBM_BYTES_PER_MS = 3.35e9  # the H100's 3.35 TB/s


def lm_trips(card, label):
    """One line per (shape, mode, stage, path) of `--lm`."""
    import dataclasses
    import json

    from spherical_bundle_adjuster_tpu_torch import problems
    from spherical_bundle_adjuster_tpu_torch.ops import cuda_lm
    from spherical_bundle_adjuster_tpu_torch.utils.config import BaConfig
    from spherical_bundle_adjuster_tpu_torch.utils.profiling import device_ms

    dev = torch.device("cuda", 0)
    # no stop test fires: every problem stays active through the timed trips
    cfg = dataclasses.replace(BaConfig(), function_tolerance=0.0, lm_lambda_up=1.0)
    for lead, m in problems.LM_SHAPES:
        prob = problems.stage_problem(lead, m, seed=7, dev=dev)
        for compat in (True, False):
            for stage, system, problem, x0, kept, lower in problems.stage_systems(prob, cfg,
                                                                                  compat):
                step, state = problems.eager_state(system, x0, cfg, lower, 0)
                own = tuple(t.clone() for t in state)
                trips = cuda_lm.Trips(problem, own, cfg, lower, kept)
                counts = torch.zeros(2, dtype=torch.int32, device=dev)
                runs = {"trip_ops": lambda: step(state), "trip_kernel": lambda: trips.run(counts)}
                nbytes = _trip_bytes(problem, own, kept, trips.scratch)
                for path, fn in runs.items():
                    dms, wms = device_ms(fn)
                    line = {"tree": label, "stage": stage, "lead": list(lead), "matches": m,
                            "mode": "compat" if compat else "corrected", "path": path,
                            "device_ms": dms, "wall_ms": wms, "card": card}
                    if path == "trip_kernel":
                        line.update(bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_MS)
                    print(json.dumps(line), flush=True)


def _trip_bytes(problem, state, kept, scratch):
    """Bytes a trip of every problem active must move: the state read and
    written, the counts, the kept mask and the problem's constants, each
    read once, and what passes between its launches (`scratch` and the
    aten calls' results: j_rep^T rep; or the step, H, g and cost), written
    once and read once."""
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    n = state[0].shape[0]
    read = size(t for t in state if t is not state[4])  # cost_s only written
    consts = size(t for t in problem if isinstance(t, torch.Tensor))
    results = 4 * n * (2 if state[0].shape[1] == 2 else 3 + 9 + 3 + 1)
    return (read + size(state) + consts + 2 * (size(scratch) + results)
            + (0 if kept is None else kept.numel()) + 8)


def main():
    import argparse
    import json
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(root))
    ap.add_argument("--label", default="this tree")
    ap.add_argument("--stage-bytes", default="", help="comma-separated staging budgets")
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--save-solves", default="", help="file to save the solver problems to")
    ap.add_argument("--solves", default="", help="time the solves saved in this file")
    ap.add_argument("--against", default="", help="with --solves: a second checkout, in turns")
    ap.add_argument("--lm", action="store_true", help="time one LM trip of each stage")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    if args.save_solves:
        return save_solves(args.save_solves)
    if not torch.cuda.is_available():
        sys.exit("kernel_times: no CUDA device")
    from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, cuda_surf, integral
    from spherical_bundle_adjuster_tpu_torch.utils.config import SurfConfig
    from spherical_bundle_adjuster_tpu_torch.utils.profiling import device_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    if args.solves:
        ports = [(args.label, load_port(tree, "port_tree"))]
        if args.against:
            ports.append((Path(args.against).resolve().name, load_port(Path(args.against).resolve(),
                                                             "port_against")))
        return time_solves(args.solves, ports, card)
    if args.lm:
        return lm_trips(card, args.label)
    dev = torch.device("cuda", 0)
    g = torch.Generator(dev).manual_seed(0)
    # the 8 bands of one 1024x2048 pair (4 pitches x 2 views), 256 x 2048
    ii = integral.integral_image(torch.rand(8, 256, 2048, device=dev, generator=g) * 255)
    d1 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    d2 = torch.nn.functional.normalize(torch.randn(2048, 64, device=dev, generator=g), dim=-1)
    v2 = torch.rand(2048, device=dev, generator=g) > 0.1
    cfg = SurfConfig(n_octaves=4)
    runs = {"det_pyramid": lambda: cuda_surf.det_pyramid_cuda(ii, cfg)}
    runs["haar_trace_maps"] = lambda: cuda_surf.haar_trace_maps_cuda(ii, cfg)
    runs["top2_distances"] = lambda: cuda_match.top2_distances_cuda(d1, d2, v2)
    for name, fn in runs.items():
        dms, wms = device_ms(fn)
        out = fn()
        torch.cuda.synchronize()
        print(json.dumps({"tree": args.label, "kernel": name, "device_ms": dms, "wall_ms": wms,
                          "out_sha": digest(out), "card": card}), flush=True)
    if not (args.stage_bytes or args.ablate):
        return
    from spherical_bundle_adjuster_tpu_torch.ops import kernels

    budgets = [int(b) for b in args.stage_bytes.split(",") if b] or [cuda_surf.STAGE_BYTES]
    q_tile = d1[: cuda_match.Q_TILE].contiguous()
    runs["top2_one_tile"] = lambda: cuda_match.top2_distances_cuda(q_tile, d2, v2)
    surf = ("det_pyramid", "haar_trace_maps")
    k3 = ("top2_distances", "top2_one_tile")
    # variant -> (macros, kernels timed)
    variants = {"full": ((), surf + k3)}
    if args.ablate:
        variants.update(
            no_stage=(("SBA_NO_STAGE",), surf + k3),
            no_compute=(("SBA_NO_COMPUTE",), surf + k3),
            no_merge=(("SBA_NO_MERGE",), k3),
        )
    for variant, (defines, names) in variants.items():
        kernels.library(defines)
        for budget in budgets:
            cuda_surf.STAGE_BYTES = budget
            cuda_surf._det_plan.cache_clear()
            cuda_surf._haar_plan.cache_clear()
            for name in names:
                if name in surf:
                    line = {"stage_bytes": budget}
                elif budget == budgets[0]:  # K3 does not read the budget
                    line = {}
                else:
                    continue
                dms, wms = device_ms(runs[name])
                print(json.dumps({"tree": args.label, "kernel": name, "variant": variant, **line,
                                  "device_ms": dms, "wall_ms": wms, "card": card}), flush=True)


if __name__ == "__main__":
    main()
