"""One run of one cell: set-up, the measured window, the readings, the output
check, and the result line's fields."""

from __future__ import annotations

import math
import sys
import time

import torch

from pbench import check, spec, trace, traffic, weights
from pbench.counts import peaks
from reference import mmbidaf_ref as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "mmbidaf_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Run:
    """What a metric reader reads (``port_bench/metrics/<name>.py``)."""

    def __init__(self, cfg: dict, mix: dict, device_name: str):
        self.cfg, self.mix = cfg, mix
        self.program = mix["program"]
        self.batch = mix["batch"]
        self.device_name = device_name
        self.peaks = peaks(device_name)
        self.setup_s = math.nan
        self.window = None
        self.trace = None


def make_inputs(cfg: dict, mix: dict, seed: int, device) -> tuple[dict, list]:
    """The weights of each layout the mix's program kind names, and the pool."""
    kind = spec.program(mix["program"])
    w = {name: weights.make(layout, seed, name, device) for name, layout in kind.layouts(cfg).items()}
    return w, traffic.pool(cfg, mix, seed, device)


def run_cell(bench: dict, cell_name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, cfg_file: dict | None = None, mix: dict | None = None) -> dict:
    """Run one cell once; returns the result line's fields and ``numbers``.
    ``cfg_file`` / ``mix`` stand in for the cell's files (tests, at small sizes)."""
    cell = spec.workload(bench, cell_name)
    mix = mix or spec.traffic(cell["traffic"])
    cfg = spec.program_config(cfg_file or spec.config_file(bench, cell["config"]), mix["program"])
    on_card = torch.device(device).type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    kind = spec.program(mix["program"])
    run = Run(cfg, mix, name)
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    stages = [("imports", time.perf_counter())]
    w, pool = make_inputs(cfg, mix, seed, device)
    stages.append(("weights and inputs", time.perf_counter()))
    prog = kind.build(cfg, mix, w, seed, device)
    stages.append(("program built", time.perf_counter()))
    prog.warm(pool)
    stages.append(("warm-up", time.perf_counter()))
    print("set-up: " + ", ".join(f"{k} {t - t0:.2f} s" for (k, t), (_, t0) in
                                 zip(stages, [("start", t_start)] + stages)), file=sys.stderr)
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        with profile(activities=acts):  # the profiler's own start-up, outside the window
            prog.window(pool, 0.0, traced=True)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(trace.WINDOW_SPAN):
                run.window = prog.window(pool, seconds, traced=True)
    else:
        run.window = prog.window(pool, seconds, traced=False)
    run.setup_s = run.window.start - t_start
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    if traced:
        t0 = time.perf_counter()
        run.trace = trace.read(prof, kind.SPANS)
        del prof
        tr = run.trace
        print(f"trace: {len(tr.device)} device activities, "
              f"{sum(1 for d in tr.device if d[3] is not None)} with their launch found, "
              f"{len(tr.host)} host events on the main thread, read in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)

    # the reference runs once the program's state is freed: it sets no peak
    t_check = time.perf_counter()
    record = prog.record()
    prog.free()
    del prog
    if on_card:
        torch.cuda.empty_cache()
    with ref.ieee_f32():
        numbers = kind.numbers(cfg, mix, w, pool, run.window, record, seed)
    print(f"output check: {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    return {"run": run, "numbers": numbers, "memory_peak": memory_peak,
            "attempted": run.window.units * run.batch}


def result_line(bench: dict, out: dict, cell_name: str, traced: bool, limits: dict) -> dict:
    run = out["run"]
    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell_name, kind):
        v = spec.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, checks = check.judge(out["numbers"], limits)
    dev = {"platform": "gpu" if run.device_name != "cpu" else "cpu", "kind": run.device_name,
           "count": 1, "memory_peak_bytes": out["memory_peak"]}
    line = {"correct": correct, "attempted": out["attempted"], "failed": 0, "metrics": metrics,
            "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = checks
    return line
