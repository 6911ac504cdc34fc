"""Structured logging and timing, ported from the JAX package's
utils/logging.py: the reference's DEBUG_PRINT macros and tick-count
timers (debug_print.h), its pose CSV (log.txt,
spherical_bundle_adjuster.cpp:348-354) and per-match depth CSV
(write_log_d, :219-225), plus JSONL metrics, behind one logger object.

The CSV rows are the JAX package's byte for byte: values are written as
str(float(v)) of the float32 numbers, so a tensor is pulled to the host
once, as float32, and never cast to float64 on the way.
"""

from __future__ import annotations

import json
import logging
import os
import time
from contextlib import contextmanager

import numpy as np
import torch

logger = logging.getLogger("sba_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("[%(name)s] %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(os.environ.get("SBA_TPU_LOGLEVEL", "INFO"))


def _host(x):
    """x as numpy: a tensor is copied off its device once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@contextmanager
def timed(label: str, sink=None):
    """Wall-clock stage timer (the START_TIME/STOP_TIME macro pair,
    debug_print.h:9-13). Yields a dict that receives {'seconds': ...}.
    Work queued on the card inside is timed only as far as the body
    waits for it."""
    rec = {}
    t0 = time.perf_counter()
    try:
        yield rec
    finally:
        rec["seconds"] = time.perf_counter() - t0
        logger.info("%s execution time : %.6f s", label, rec["seconds"])
        if sink is not None:
            sink(label, rec["seconds"])


class RunLogger:
    """Writes JSONL metrics plus reference-format CSV logs."""

    def __init__(self, out_dir: str = "match_result"):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.jsonl_path = os.path.join(out_dir, "metrics.jsonl")

    def metric(self, **kv):
        kv.setdefault("ts", time.time())
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(kv, default=float) + "\n")

    def pose_csv(self, expected_rpy, solved_rot_deg, solved_tran, match_size,
                 path="log.txt"):
        """Append the reference's pose CSV row (:348-354)."""
        row = (list(expected_rpy) + list(_host(solved_rot_deg)) + list(_host(solved_tran))
               + [match_size])
        with open(os.path.join(self.out_dir, path), "a") as f:
            f.write(",".join(str(float(v)) for v in row[:-1]) + f",{int(row[-1])}\n")

    def depth_csv(self, depths, valid=None, path="log_d.txt"):
        """Append per-match (d1, d2) rows (write_log_d, :219-225)."""
        d = _host(depths)
        v = np.ones(len(d), bool) if valid is None else _host(valid)
        with open(os.path.join(self.out_dir, path), "a") as f:
            for i in range(len(d)):
                if v[i]:
                    f.write(f"{float(d[i][0])},{float(d[i][1])}\n")
