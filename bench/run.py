"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (spans, counts and a profiler trace of the window) and
the ``breakdown``.  A metric named ``<quantity>.<workload>`` is that
cell's own entry of the quantity (with its own bound or ``moves``), read
as the quantity is.  Both check what the window served against
the plain reference.  The last line of standard output is the result's
JSON; the numbers compared, beside their limits, close standard error
and the result (``check``).  Without a CUDA card, or with fewer cards
than the cell asks for, it exits 1 and prints no result.

``bench/calibrate.py`` runs many seeds, other rates and the fp8 control
in one process, for setting the limits.

Build caches live in the checkout: the port's kernels in
``build/kernels``, Triton's and torch's extension caches under ``build/``.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(name: str):
    path = ROOT / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def base(name: str, workload: str) -> str:
    """A metric's quantity: its name less a ``.<workload>`` suffix, which
    a cell's own entry of a quantity carries (its own bound, or its own
    ``moves``)."""
    tail = f".{workload}"
    return name[:-len(tail)] if name.endswith(tail) else name


def applies(entry: dict, workload: str, reported) -> bool:
    if "workloads" in entry:
        return workload in entry["workloads"]
    return reported is None or entry.get("moves") in reported


def result(workload: str, trace: bool, r: dict, bench: dict) -> dict:
    import torch
    from bench import check as C
    e2e = [m for m in bench["end_to_end"] if applies(m, workload, None)]
    metrics = {}
    if not trace:
        for m in e2e:
            v = r["e2e"].get(base(m["name"], workload))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        names = {m["name"] for m in e2e}
        for m in bench["per_layer"]:
            if applies(m, workload, names):
                v = reader(base(m["name"], workload))(r["ctx"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1, "memory_peak_bytes": r["peak"]}
    out = {"correct": bool(r["gap"] <= r["limit"]),
           "attempted": r["attempted"], "failed": r["failed"],
           "metrics": metrics, "device": dev}
    if trace:
        t = r["ctx"].get("trace", {})
        dev["busy_s"] = t.get("busy_s", 0.0)
        dev["window_s"] = t.get("window_s", r["ctx"]["window_s"])
        out["breakdown"] = {"device_ops": t.get("device_ops", []),
                            "idle_gaps": t.get("idle_gaps", [])}
    out["check"] = {C.NUMBER: {"value": r["gap"], "limit": r["limit"]}}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch
    from bench import harness
    bench = harness.benchmark()
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 1
    import subprocess
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    harness.log(f"{args.workload} seed {args.seed} trace {args.trace}: "
                f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    r = harness.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"the process loaded {bad}: refused", file=sys.stderr)
        return 3
    out = result(args.workload, bool(args.trace), r, bench)
    for k, v in out["check"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
