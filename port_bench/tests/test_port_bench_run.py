"""One cell of each kind end to end on the CPU at tiny widths, the result
line's shape, the import check, and the CLI's refusal without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from pbench import core, spec

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")


def run_tiny(tiny, cell, traced=False, seconds=1.0, seed=2**31 + 11):
    bench, cfg, mix = tiny(cell)
    out = core.run_cell(bench, cell, seed, seconds, traced, "cpu", time.perf_counter(), cfg, mix)
    return bench, out, core.result_line(bench, out, cell, traced, spec.limits(cell))


@pytest.mark.parametrize("cell", ["serve.h128.b64", "train.h512.b32"])
def test_cell_end_to_end_prints_one_json_line(tiny, cell, capsys):
    import run

    bench, out, line = run_tiny(tiny, cell)
    run.report(line)
    captured = capsys.readouterr()
    last = json.loads(captured.out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks" and last["correct"] is True
    assert last["attempted"] == out["run"].window.units * out["run"].batch > 0
    names = {m["name"] for m in spec.metrics_of(bench, cell, "end_to_end")}
    assert set(last["metrics"]) == names
    assert all(v["value"] > 0 for v in last["metrics"].values())
    err = captured.err.strip().splitlines()
    assert [e.split()[1] for e in err[-len(last["checks"]):]] == list(last["checks"])


@pytest.mark.parametrize("cell", ["serve.h128.b64", "train.h512.b32"])
def test_traced_run_on_the_cpu_reads_no_device_metric(tiny, cell):
    _, _, line = run_tiny(tiny, cell, traced=True)
    # no device activity on the CPU: no device metric is written
    assert line["metrics"] == {} and line["device"]["busy_s"] == 0.0
    assert line["correct"] is True and set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_inputs(tiny):
    bench, cfg, mix = tiny("train.h512.b32")
    c = spec.program_config(cfg, "train")
    a = core.make_inputs(c, mix, 5_000_000_000, "cpu")
    b = core.make_inputs(c, mix, 5_000_000_000, "cpu")
    assert all((a[0]["model"][k] == b[0]["model"][k]).all() for k in a[0]["model"])
    assert all((x[k] == y[k]).all() for x, y in zip(a[1], b[1]) for k in x)


def test_no_jax_in_a_run():
    """A tiny run in a fresh process loads nothing named jax, jaxlib, flax or
    mmbidaf_tpu (the port's own name, mmbidaf_tpu_torch, is allowed)."""
    code = (
        "import sys, time; sys.path[:0] = [{b!r}, {r!r}]\n"
        "sys.path.insert(0, {t!r})\n"
        "from conftest import tiny_files\n"
        "from pbench import core\n"
        "bench, cfg, mix = tiny_files('serve.h128.b64')\n"
        "core.run_cell(bench, 'serve.h128.b64', 3, 0.1, False, 'cpu', time.perf_counter(), cfg, mix)\n"
        "import reference.mmbidaf_ref\n"
        "print(core.forbidden_modules(), 'mmbidaf_tpu_torch' in sys.modules)\n"
    ).format(b=os.path.dirname(RUN), r=os.path.dirname(os.path.dirname(RUN)),
             t=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {b!r}); import reference.mmbidaf_ref\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('mmbidaf')))"
            ).format(b=os.path.dirname(RUN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]


def test_cli_refuses_without_a_card(tmp_path):
    out = subprocess.run([sys.executable, RUN, "--workload", "serve.h128.b64", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
