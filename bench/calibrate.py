"""Readings for the benchmark's limits and bounds, many seeds in one
process (the kernels built and the model's code loaded once):

    python3 bench/calibrate.py --workload <name> --seconds <s> \\
        --seeds 1,2,3 [--control-seeds 1,2] [--rates 0.1,0.2] \\
        [--faults state_unchanged,half_batch,token_altered]

Each seed is a whole run as ``bench/run.py`` makes it (fresh weights,
engine, warm-up, window, check); ``--control-seeds`` also read the fp8
control on the same sample and judge it by the cell's limit, as
``correct`` judges the program.  ``--rates`` runs the window at each
offered rate instead (the knee sweep: the backlog of requests waiting for
a slot at a quarter, half, three quarters and the end of the window).
``--faults`` then runs the first seed once more with each fault of
``bench/faults.py`` planted under the timed path.  One JSON line a run on
standard output: every reading of the check (``check.readings``), the
one compared with its limit and whether it is correct."""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run as entry  # noqa: E402,F401  (paths and environment)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--rates", default="")
    ap.add_argument("--faults", default="")
    a = ap.parse_args()
    import torch
    from bench import check as C
    from bench import faults, harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    seeds = [int(x) for x in a.seeds.split(",")]
    ctrl = {int(x) for x in a.control_seeds.split(",") if x}
    rates = [float(x) for x in a.rates.split(",") if x] or [None]
    runs = [(rate, seed, None) for rate in rates for seed in seeds] \
        + [(None, seeds[0], f) for f in a.faults.split(",") if f]
    t_start = T0
    for rate, seed, fault in runs:
        r = harness.run(a.workload, seed, a.seconds, False,
                        device="cuda", rate=rate,
                        control=seed in ctrl and fault is None,
                        hook=faults.FAULTS[fault] if fault else None,
                        t_start=t_start)
        line = {"seed": seed, "rate": rate, "fault": fault,
                "readings": r["readings"], "limit": r["limit"],
                "correct": r["gap"] <= r["limit"],
                "control": r.get("control"),
                "control_correct": r.get("control_correct"),
                "number": C.NUMBER, "check_s": r["check_s"],
                "peak": r["peak"], "backlog": r["backlog"],
                "iterations": r["ctx"]["iterations"],
                "window_s": r["ctx"]["window_s"],
                "queue_wait_ms": (1e3 * sum(r["ctx"]["queue_waits"])
                                  / max(1, len(r["ctx"]["queue_waits"]))),
                **{k: v for k, v in r["e2e"].items()}}
        print(json.dumps(line), flush=True)
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t_start = time.time()
    return 0


if __name__ == "__main__":
    sys.exit(main())
