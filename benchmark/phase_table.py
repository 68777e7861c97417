"""The train step's phase table for one cell, on the card: the program's
recorder of spans and counters (`leco_tpu_torch.utils.profiling`) on over
set-up and over one profiled pair, read by `phases.py`.

    python3 benchmark/phase_table.py --workload <name> --seed <n> [--seconds <s>]

from the root of a checkout. Set-up is the runner's (`runners/lora_train.py`:
the drawn weights, LoRA, AdamW, the step, and ceil(`checked_steps` / 2)
pairs), with the recorder on. Then pairs run for `--seconds`, the recorder
off and on by turns (off, on, on, off, ...; a whole number of such fours),
and the median seconds of a pair on against off give its cost. Then one pair runs under `tracing.profile_pair` with the recorder
on. Standard error gets the phase table; the last line of standard output
is one JSON object: set-up's library span and counters, the pairs' seconds
off and on, the phases and `phases.per_layer`'s numbers. No reference is followed here:
`run.py` decides `correct`.

The benchmark itself (`run.py`) leaves the recorder off: its runner does not
turn it on, so these numbers are not in its result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import harness  # noqa: E402
import phases  # noqa: E402
import tracing  # noqa: E402


def cell_of(workload: str, seed: int, seconds: int, started: float) -> harness.Cell:
    """The traced cell `workload` of `BENCHMARK.json`, as `harness.main` makes it
    (no limits: nothing is compared here)."""
    bench = harness.manifest()
    w = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == w["config"])
    return harness.Cell(
        name=workload, chips=w["chips"],
        config=json.loads((harness.ROOT / config["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text()),
        limits={}, seed=seed, seconds=seconds, trace=True, process_start=started)


def main(argv: list[str], started: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, default=60)
    args = ap.parse_args(argv)

    rec = phases.recorder()
    if rec is None:
        print("this checkout's program has no recorder of spans", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("the phase table needs a CUDA device", file=sys.stderr)
        return 3
    cell = cell_of(args.workload, args.seed, args.seconds, started)
    runner = harness.load_module(HERE / "runners" / f"{cell.traffic['runner']}.py")
    tr = cell.traffic
    res = tr["resolution"]

    rec.enable(True)
    inputs = runner.draw_inputs(cell, "cuda")
    bundle, _, step, _, (pack, gs, sign) = runner.build_program(cell, "cuda", inputs)

    def iterate(t_to: int) -> float:
        return step(pack, gs, sign, t_to, height=res, width=res,
                    latents=inputs.latents.next()).item()

    for _ in range(max(1, math.ceil(tr["checked_steps"] / 2))):
        for t_to in inputs.pairs.next_pair():
            iterate(t_to)
    torch.cuda.synchronize()
    rec.enable(False)
    setup = phases.setup(rec.take())
    runner.stage(cell, f"set-up: kernel library {setup['kernel_library_s']} s, nvcc runs "
                       f"{setup['nvcc_runs']}, counters {setup['counters']}")

    pair_s: dict = {False: [], True: []}
    spans, turns, n = 0, (False, True, True, False), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds or n % 4:
        on, n = turns[n % 4], n + 1
        rec.enable(on)
        p0 = time.perf_counter()
        for t_to in inputs.pairs.next_pair():
            iterate(t_to)
        pair_s[on].append(time.perf_counter() - p0)
        rec.enable(False)
        spans += len(rec.take()["spans"])
    off_s, on_s = statistics.median(pair_s[False]), statistics.median(pair_s[True])
    cost = {"pair_s_off": pair_s[False], "pair_s_on": pair_s[True], "median_off_s": off_s,
            "median_on_s": on_s, "on_cost_pct": 100.0 * (on_s / off_s - 1.0), "spans": spans}
    runner.stage(cell, f"recorder off and on by turns, {len(pair_s[False])} pairs each: median "
                       f"{off_s:.4f} s off, {on_s:.4f} s on a pair ({cost['on_cost_pct']:+.3f}%); "
                       f"{spans} spans")

    pair = inputs.pairs.next_pair()
    rec.enable(True)
    session = tracing.profile_pair(lambda: [iterate(t_to) for t_to in pair], bundle.unet)
    rec.enable(False)
    p = phases.read(session, rec.take())
    traced = tracing.analyze(session, len(pair))
    runner.stage(cell, phases.table(p, len(pair), sum(traced["by_category_ms"].values())))
    out = {
        "workload": cell.name, "seed": cell.seed, "device": torch.cuda.get_device_name(0),
        "power_limit": runner.power_limit(), "pair_t_to": list(pair),
        "setup": {k: setup[k] for k in ("kernel_library_s", "nvcc_runs", "counters")},
        "recorder_cost": cost, "launches": traced["launches"], "busy_s": traced["busy_s"],
        "wall_s": traced["wall_s"], "phases": p,
        "per_layer": phases.per_layer(p, len(pair), setup),
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    started = harness.process_start()
    cache = HERE.parent / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.exit(main(sys.argv[1:], started))
