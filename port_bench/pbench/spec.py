"""Find a cell's configuration, traffic mix, program kind, limits and metric
readers by the names ``BENCHMARK.json`` and the mix give them. Nothing here names a cell: a new cell
is new entries and new files."""

from __future__ import annotations

import copy
import functools
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_file(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def program_config(cfg_file: dict, program: str) -> dict:
    """The configuration a program runs: the file's ``model`` / ``data`` /
    ``train`` / ``mesh`` sections with its ``programs[program]`` overlay."""
    base = {k: cfg_file[k] for k in ("model", "data", "train", "mesh")}
    return _merge(base, cfg_file["programs"][program])


def traffic(name: str) -> dict:
    with open(BENCH_DIR / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell: str) -> dict:
    """``{number: limit}`` of the cell's output check."""
    with open(BENCH_DIR / "limits" / f"{cell}.json") as f:
        return {k: v["limit"] for k, v in json.load(f)["numbers"].items()}


def metrics_of(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` entries the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def _load(folder: str, name: str):
    path = BENCH_DIR / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench_{folder}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``read(run) -> float | None`` from ``port_bench/metrics/<name>.py``."""
    return _load("metrics", name).read


@functools.cache
def program(kind: str):
    """The module ``port_bench/programs/<kind>.py`` of a mix's ``program``:
    ``SPANS``, ``NUMBERS`` (the output check's), ``layouts(cfg)`` (the
    weights to make), ``make_batch(cfg, mix, gen, device)``,
    ``build(cfg, mix, weights, seed, device)`` (with ``warm``, ``window``,
    ``record`` and ``free``), ``numbers(cfg, mix, w, pool, window, record,
    seed)`` and ``readings(cfg, mix, seed, kind, device)`` (``calibrate.py``)."""
    return _load("programs", kind)
