"""Read the numbers that decide a cell's `correct`, at the cell's own
size on the card, to set its limits (`limits/<cell>.json`): the program's
on many seeds (a window of one pair unless `--seconds` says more), a
fault's, and the control's (the reference in float8 operands in the
program's place).

    PYTHONPATH=benchmark:. python3 benchmark/readings.py <cell> \\
        --program 101,102 --fault half_batch:201,202 --control 301,302

One JSON line a run on standard output: its kind, seed, `correct` under
the cell's limits file, and what the reference read.
"""

from __future__ import annotations

import argparse
import json
import time

import faults
import harness


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("workload")
    ap.add_argument("--program", default="")
    ap.add_argument("--fault", action="append", default=[], help="name:seed,seed")
    ap.add_argument("--control", default="")
    ap.add_argument("--witness", default="",
                    help="seeds: the reference in bfloat16 operands over the set-up steps")
    ap.add_argument("--late-witness", default="",
                    help="seeds: the program, with the reference in bfloat16 operands "
                         "also following the pair after the window from its state")
    ap.add_argument("--seconds", type=int, default=0, help="the program's and faults' window")
    args = ap.parse_args(argv)
    bench = harness.manifest()
    w = next(x for x in bench["workloads"] if x["name"] == args.workload)
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
    runner = harness.load_module(harness.HERE / "runners" / f"{traffic['runner']}.py")
    config = json.loads((harness.ROOT / entry["file"]).read_text())
    limits = json.loads((harness.HERE / "limits" / f"{args.workload}.json").read_text())

    def cell(seed):
        return harness.Cell(args.workload, w["chips"], config, traffic, limits["limits"],
                            int(seed), args.seconds, False, time.time())

    def emit(kind, seed, out):
        print(json.dumps({"kind": kind, "workload": args.workload, "seed": int(seed), **out}),
              flush=True)

    def outcome(record):
        return {"correct": record["correct"], "attempted": record["attempted"],
                "window_s": record["window_s"], **record["reference"]}

    for seed in filter(None, args.program.split(",")):
        emit("program", seed, outcome(runner.run_on(cell(seed), "cuda")))
    for seed in filter(None, args.late_witness.split(",")):
        emit("program", seed, outcome(runner.run_on(cell(seed), "cuda", late_witness="bf16")))
    for spec in args.fault:
        name, seeds = spec.split(":")
        for seed in seeds.split(","):
            record = runner.run_on(cell(seed), "cuda", fault=faults.FAULTS[name])
            faults.restore()
            emit(name, seed, outcome(record))
    for seed in filter(None, args.control.split(",")):
        emit("control", seed, runner.control(cell(seed), "cuda"))
    for seed in filter(None, args.witness.split(",")):
        emit("witness_bf16", seed, runner.control(cell(seed), "cuda", "bf16", after_window=False))


if __name__ == "__main__":
    main()
