"""The benchmark's general part: find the cell in `BENCHMARK.json`, its
configuration, traffic mix and limits by name, check the card, hand the
cell to the runner its traffic names, read every metric of the run through
the metric's own reader, check that no JAX module was loaded, and print the
result line.

Each piece is a file of its own, found by name, so that a later cell,
traffic mix or metric is added as files and entries:

    configs/<config>.json     the configuration (BENCHMARK.json's `file`)
    traffic/<traffic>.json    the mix: sizes, recipe, and its `runner`
    limits/<workload>.json    the limit of each number that decides `correct`
    runners/<runner>.py       run(cell) -> the run's record
    metrics/<metric>.py       read(record) -> the metric's value, or None
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "leco_tpu")


@dataclasses.dataclass
class Cell:
    """One run of one workload, as the runner gets it."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: int
    trace: bool
    process_start: float  # time.time() at which the process started


def load_module(path: Path):
    name = f"bench_{path.parent.name}_{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metric entries a run of `workload` reports: the end-to-end ones
    untraced, the per-layer ones traced; each where its `workloads`, if
    given, lists the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def _number(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else str(x)


def result_line(record: dict, metric_values: dict) -> dict:
    """The last line's object; the compared numbers come last."""
    line = {
        "correct": record["correct"],
        "attempted": record["attempted"],
        "failed": record["failed"],
        "metrics": metric_values,
        "device": record["device"],
    }
    if record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = {k: {"value": _number(c["value"]), "limit": c["limit"]}
                      for k, c in record["checks"].items()}
    return line


def process_start() -> float:
    """time.time() at which this process started (from /proc), or now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def main(argv: list[str], started: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    w = cells[args.workload]
    config_entry = next(c for c in bench["configs"] if c["name"] == w["config"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"{args.workload} needs {w['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3

    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    cell = Cell(
        name=args.workload, chips=w["chips"],
        config=json.loads((ROOT / config_entry["file"]).read_text()),
        traffic=traffic,
        limits=json.loads((HERE / "limits" / f"{args.workload}.json").read_text())["limits"],
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace), process_start=started)
    runner = load_module(HERE / "runners" / f"{traffic['runner']}.py")
    record = runner.run(cell)

    values = {}
    for m in metrics_of(bench, args.workload, cell.trace):
        value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 4
    line = result_line(record, values)
    for k, c in line["checks"].items():
        print(f"{k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
