"""BENCHMARK.json and the files it names: every entry is found by name and
keeps to the benchmark's contract."""

import json
import re

import pytest

from pbench import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["port_bench"] and bench["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert len(json.dumps(bench)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entry_keys(bench, kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}[kind]
    for e in bench[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_every_cell_finds_its_files(bench):
    configs = {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        mix = spec.traffic(w["traffic"])
        cfg = spec.program_config(spec.config_file(bench, w["config"]), mix["program"])
        assert cfg["model"]["hidden_size"] > 0
        assert set(spec.limits(w["name"])) == set(spec.program(mix["program"]).NUMBERS)
        e2e = spec.metrics_of(bench, w["name"], "end_to_end")
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert spec.metrics_of(bench, w["name"], "per_layer")


def test_every_mix_finds_its_program_kind(bench):
    for mix_name in sorted({w["traffic"] for w in bench["workloads"]}):
        kind = spec.program(spec.traffic(mix_name)["program"])
        for attr in ("SPANS", "NUMBERS", "layouts", "make_batch", "build", "numbers", "readings"):
            assert hasattr(kind, attr), (mix_name, attr)


def test_every_metric_has_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
        assert m["source"] in (("host_clock", "device_trace") if m["name"] in e2e else
                               ("device_trace", "program_span", "program_counter", "host_clock"))
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            reports = {x["name"] for x in spec.metrics_of(bench, cell, "end_to_end")}
            assert m["moves"] in reports


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25


def test_config_files(bench):
    for c in bench["configs"]:
        assert c["file"].startswith("port_bench/configs/") and c["source"].startswith("https://")
        f = spec.config_file(bench, c["name"])
        assert sorted(f["reduced"]) == sorted(c["reduced"]) and len(f["source"]) <= 200
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank", "_size"))
