"""Run one cell of the port's benchmark once, on the card this process sees.

    python port_bench/run.py --workload serve.h128.b64 --seed 7 --seconds 30 --trace 0

Measures ``mmbidaf_tpu_torch`` only. ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics from a profiled
window. The last line of standard output is one JSON object; the last lines
of standard error give each number of the output check beside its limit.
Exits non-zero, printing no result, without a CUDA card, when the program
cannot be imported from this checkout, or when JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """``perf_counter`` at this process's start (from /proc where it can)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)


def report(line: dict) -> None:
    """Each compared number beside its limit on standard error, then the
    result as the last line of standard output."""
    import json

    for k, v in line["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    t_start = _process_start()
    # kernel caches of any library the program loads, at fixed paths in the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CHECKOUT, ".bench_cache", sub)
    for p in (CHECKOUT, HERE):
        if p not in sys.path:
            sys.path.insert(0, p)
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    import torch

    import mmbidaf_tpu_torch
    from pbench import core, spec

    if not os.path.abspath(mmbidaf_tpu_torch.__file__).startswith(CHECKOUT + os.sep):
        print(f"run.py: the program under test must come from this checkout, not "
              f"{mmbidaf_tpu_torch.__file__}", file=sys.stderr)
        return 5

    bench = spec.load_benchmark()
    cell = spec.workload(bench, a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: {cell['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    limits = spec.limits(a.workload)
    out = core.run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    line = core.result_line(bench, out, a.workload, bool(a.trace), limits)
    bad = core.forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    report(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
