"""Readings that set a cell's output-check limits, in one process on the card.

    python port_bench/calibrate.py --workload serve.h128.b64 \\
        --seeds 101-112 --control 201-203 --faults 301-303

The readings are the cell's program kind's (``readings`` in
``port_bench/programs/<kind>.py``). For each ``--seeds`` seed: the cell's
weights and pool from the seed, the timed entry at the cell's sizes on
every batch of the pool (serving) or through the first checked steps
(training), and the output check's numbers as a run computes them: the
lower readings. For each ``--control`` seed the reference computed in the
next lower precision than the configuration's (serving: fp8 products where
the program computes in bf16; training: TF32 products for the f32
program) in the program's place, judged the same way: the upper readings.
For each ``--faults`` seed the fault the cell can have, planted in the
program: a served pick altered where it is produced (serving); half of the
batch left out, the mean taken over the rest (training); ``--unchanged``:
a train step that returns its state unchanged. One JSON line a reading,
then the largest program reading and the smallest control and fault
readings of each number.
"""

from __future__ import annotations

import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out += list(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    from pbench import spec

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--unchanged", default="", help="training: seeds of a state left unchanged")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 3
    bench = spec.load_benchmark()
    cell = spec.workload(bench, a.workload)
    mix = spec.traffic(cell["traffic"])
    cfg = spec.program_config(spec.config_file(bench, cell["config"]), mix["program"])
    readings = spec.program(mix["program"]).readings
    summary = {}
    for kind, text in (("program", a.seeds), ("control", a.control), ("fault", a.faults),
                       ("unchanged", a.unchanged)):
        for seed in seeds(text):
            numbers = readings(cfg, mix, seed, kind, "cuda")
            print(json.dumps({"kind": kind, "seed": seed, **numbers}), flush=True)
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(summary.get(kind, {}).get(k, v), v) for k, v in numbers.items()}
    print(json.dumps({"workload": a.workload, "device": torch.cuda.get_device_name(0),
                      "program_max": summary.get("program"), "control_min": summary.get("control"),
                      "fault_min": summary.get("fault"), "unchanged_min": summary.get("unchanged")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
