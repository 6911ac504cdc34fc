"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It makes the cell's inputs from the seed on the card, loads and
warms up the program (set-up), runs the closed loop for --seconds, and
with --trace 1 also traces a few calls and probes the entry's layers.
Then it frees what it can, checks the window's answers against the
plain reference (benchmark/reference) and prints, as the last line of
standard output, one JSON object: correct, attempted, failed, metrics,
device (and breakdown with --trace 1), and checks, each compared number
with its limit, which also end standard error. Without the cards, or
with JAX loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up runs from here to the window's first call

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "spherical_bundle_adjuster_tpu"}
JUDGED_ANSWERS = 16  # pair answers of the window the reference judges
ROWS_PER_CALL = 4    # at most this many of one call's pairs
PROBE_CALLS = 3   # calls of each probe (front end, refinement) in a traced run


def cache_dirs():
    """Every build or kernel cache inside the checkout, at fixed paths."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def loaded_forbidden():
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def merged_pipeline(config, traffic):
    """The configuration's pipeline fields with the traffic's request on top."""
    pipe = json.loads(json.dumps(config["pipeline"]))
    for group, over in traffic.get("request", {}).items():
        pipe[group].update(over)
    return pipe


def event_ms(fn):
    """Wall ms of fn() between two CUDA events, the card idle before."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def traced(system, cell_rows, config, pipeline):
    """The traced sub-window and the probes: the readers' context, the
    breakdown and the device's busy and window seconds."""
    from . import trace
    from .system import sync_counter

    n_calls = 4 if system.per_call == 1 else 1  # traced calls: a few pairs, or one batch
    rows_list = [cell_rows(k) for k in range(n_calls)]
    red = trace.reduce_events(trace.profile_calls(system, rows_list))
    spans = {"frontend_ms": [], "refine_ms": []}
    for k in range(PROBE_CALLS):
        rows = cell_rows(k)
        ms, fr = event_ms(lambda: system.frontend(rows))
        spans["frontend_ms"].append(ms)
        spans["refine_ms"].append(event_ms(lambda: system.refine(fr, rows))[0])
        del fr
    with sync_counter() as syncs:
        system.call(cell_rows(0))
    ctx = dict(trace=red, spans=spans, counters={"host_syncs": syncs[0]},
               traced_pairs=n_calls * system.per_call, height=config["image"]["height"],
               width=config["image"]["width"], pipeline=pipeline)
    w0, w1 = red["window_us"]
    return ctx, trace.breakdown(red), red["busy_us"] * 1e-6, (w1 - w0) * 1e-6


def judged_sample(answers, seed):
    """(rows, answer, positions) of the window's calls whose answers are
    judged: JUDGED_ANSWERS pair answers, at most ROWS_PER_CALL of a call,
    drawn from the seed."""
    import numpy as np

    per_call = len(answers[0][0])
    take = min(per_call, ROWS_PER_CALL)
    rng = np.random.default_rng(np.random.SeedSequence([abs(int(seed)), 1]))
    calls = rng.choice(len(answers), size=min(len(answers), JUDGED_ANSWERS // take), replace=False)
    return [(answers[k][0], answers[k][1], sorted(rng.choice(per_call, take, replace=False).tolist()))
            for k in sorted(calls.tolist())]


def failed_pairs(out) -> int:
    """Pairs of a call's answer with no consensus initial guess or a pose
    that is not finite."""
    import numpy as np

    ok = np.asarray(out.ok).reshape(-1)
    n = ok.shape[0]
    for x in (out.rotation_aa, out.translation):
        ok = ok & np.isfinite(np.asarray(x)).reshape(n, -1).all(axis=1)
    return int(n - ok.sum())


def program_counts(answers, on_card):
    """What the program counts, for an earlier line: its kernels' launches
    (on the card) and the LM iterations of each BCD stage (mean a pair)."""
    import numpy as np

    its = {}
    for stage in ("depth", "rot", "tran"):
        vals = [np.asarray(getattr(a.telemetry, stage).iterations).sum(-1).mean()
                for _, a in answers if hasattr(a, "telemetry")]
        its[stage] = float(np.mean(vals)) if vals else None
    out = {"lm_iterations_per_pair": its}
    if on_card:
        from spherical_bundle_adjuster_tpu_torch.ops import cuda_match, cuda_surf

        out["launches"] = {k.symbol: k.launches for k in (cuda_surf.DET_PYRAMID,
                                                         cuda_surf.HAAR_TRACE, cuda_match.TOP2)}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs()
    import torch

    from . import spec

    bench = spec.Spec()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run_cell(bench, cell, args, torch.device("cuda", 0))


def run_cell(bench, cell, args, device, corrupt=None) -> int:
    """Set-up, window, trace and check of one cell on `device`. `corrupt`,
    given, breaks the timed path's answers (the harness's own tests)."""
    import numpy as np
    import torch

    from . import generator, window
    from .reference import compare
    from .system import System, pipeline_config

    on_card = device.type == "cuda"
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    checks = bench.checks(cell["name"])
    pipeline = merged_pipeline(config, traffic)
    cfg = pipeline_config(config, traffic)
    t_inputs = time.perf_counter()
    inputs = generator.make_inputs(config, traffic, cfg.ransac.num_trials, cfg.match.max_matches,
                                   args.seed, device)
    if on_card:
        torch.cuda.synchronize()
    t_inputs = time.perf_counter() - t_inputs
    system = System(config, traffic, inputs, device)
    per_call, pool = config["pairs_per_call"], traffic["pool_pairs"]
    chunk = 0 if per_call == 1 else system.batch_chunk  # pairs a front-end pass
    if corrupt is not None:
        system = corrupt(system)

    def cell_rows(k):
        return generator.call_rows(k, per_call, pool)

    t_warm = time.perf_counter()
    for k in range(2):  # warm-up: every shape the window uses
        system.call(cell_rows(k))
    if on_card:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - T_START
    print(json.dumps({"setup": {"before_inputs_s": setup_s - t_inputs - (t_end - t_warm),
                                "inputs_s": t_inputs, "warm_up_s": t_end - t_warm}}), flush=True)

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if tf32 != (config["tf32"],) * 2:
        print(f"benchmark: the configuration states TF32 {config['tf32']}; the program runs with "
              f"matmul / cuDNN TF32 {tf32}", file=sys.stderr)
        return 4
    w = window.run_window(system, args.seconds, per_call, pool, generator.call_rows, first_call=2)
    metrics = {m["name"]: {"value": window.END_TO_END[m["name"]](w), "unit": m["unit"]}
               for m in bench.end_to_end(cell["name"]) if m["name"] != "setup_s"}
    metrics["setup_s"] = {"value": setup_s, "unit": "s"}

    result_extra, device_info = {}, {"platform": "gpu" if on_card else device.type,
                                     "kind": torch.cuda.get_device_name(device) if on_card
                                     else "cpu", "count": cell["chips"]}
    if args.trace:
        ctx, brk, busy_s, window_s = traced(system, cell_rows, config, pipeline)
        metrics = {}
        for m in bench.per_layer(cell["name"]):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=busy_s, window_s=window_s)
        result_extra["breakdown"] = brk
        print(json.dumps({"host_syncs_per_call": ctx["counters"]["host_syncs"]}), flush=True)
    device_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device) if on_card
                                        else 0)
    del system
    if on_card:
        torch.cuda.empty_cache()

    # the check: a sample of the window's answers drawn from the seed
    t0 = time.perf_counter()
    per_answer = compare.judge_calls(config, traffic, inputs, judged_sample(w.answers, args.seed),
                                     chunk)
    correct, table = compare.judge(per_answer, checks["limits"])
    failed = sum(failed_pairs(out) for _, out in w.answers)
    check_s = time.perf_counter() - t0

    bad = loaded_forbidden()
    if bad:
        print(f"benchmark: JAX is loaded in this process: {bad}", file=sys.stderr)
        return 3
    card = power_limit() if on_card else None
    print(json.dumps({"program_counts": program_counts(w.answers, on_card)}), flush=True)
    half = len(w.call_s) // 2
    print(json.dumps({"call_ms_quartiles": [
        [1e3 * q for q in statistics.quantiles(part, n=4)] for part in (w.call_s[:half],
                                                                        w.call_s[half:])
        if len(part) > 1]}), flush=True)
    print(json.dumps({"judged_answers": len(per_answer), "check_s": check_s, "card": card,
                      "lists_differ": sum(r["lists_differ"] for r in per_answer),
                      "window_s": w.seconds, "calls": len(w.call_s)}), flush=True)
    compared = {k: vl for k, vl in table.items() if vl[1] is not None}
    print(json.dumps({"not_compared": {k: v for k, (v, lim) in table.items() if lim is None}}),
          flush=True)
    for k, (v, lim) in compared.items():
        print(f"check {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    result = {"correct": correct, "attempted": w.pairs, "failed": failed,
              "metrics": metrics, "device": device_info, **result_extra,
              "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
