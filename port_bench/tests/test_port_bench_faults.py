"""The output check fails what it should: the control (the reference in the
next lower precision, in the program's place) and each fault a cell can
have, planted under a whole run, come out not correct under the cells'
limits. At CPU size; ``calibrate.py`` reads the same on the card at the
cells' sizes."""

import time

import pytest
import torch

from pbench import check, core, spec


def judged(cell, numbers):
    return check.judge(numbers, spec.limits(cell))[0]


@pytest.mark.parametrize("cell", ["serve.h128.b64", "serve.h512.b64", "train.h512.b32"])
def test_control_is_not_correct(tiny, cell):
    _, cfg_file, mix = tiny(cell)
    cfg = spec.program_config(cfg_file, mix["program"])
    read = spec.program(mix["program"]).readings
    assert judged(cell, read(cfg, mix, 41, "program", "cpu"))
    assert not judged(cell, read(cfg, mix, 41, "control", "cpu"))


def run_broken(tiny, cell):
    bench, cfg, mix = tiny(cell)
    out = core.run_cell(bench, cell, 77, 0.2, False, "cpu", time.perf_counter(), cfg, mix)
    return core.result_line(bench, out, cell, False, spec.limits(cell))["correct"]


def test_served_pick_altered(tiny, monkeypatch):
    from mmbidaf_tpu_torch.data import frontend

    real = frontend.make_end_to_end_decode

    def broken(cfg, *a, **k):
        entry = real(cfg, *a, **k)

        def altered(model, fe, raw):
            log_p, picks = entry(model, fe, raw)
            picks = picks.clone()
            picks[0, 0] = (picks[0, 0] + 1) % log_p.shape[-1]
            return log_p, picks

        return altered

    monkeypatch.setattr(frontend, "make_end_to_end_decode", broken)
    assert not run_broken(tiny, "serve.h128.b64")


def _wrap_step(monkeypatch, wrap):
    from mmbidaf_tpu_torch.train import loop

    real = loop.make_train_step
    monkeypatch.setattr(loop, "make_train_step", lambda cfg, *a, **k: wrap(real(cfg, *a, **k)))


def test_state_left_unchanged(tiny, monkeypatch):
    _wrap_step(monkeypatch, spec.program("train").unchanged)
    assert not run_broken(tiny, "train.h512.b32")


def test_half_the_batch_left_out(tiny, monkeypatch):
    _wrap_step(monkeypatch, spec.program("train").half_batch)
    assert not run_broken(tiny, "train.h512.b32")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["serve.h128.b64", "serve.h512.b64", "train.h512.b32"])
def test_control_at_the_cells_size_on_the_card(cell):
    """The control on three seeds at the cell's own size is not correct, and
    the program on the same seeds is (``calibrate.py``'s readings)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell's own size runs on the card")
    bench = spec.load_benchmark()
    w = spec.workload(bench, cell)
    mix = spec.traffic(w["traffic"])
    cfg = spec.program_config(spec.config_file(bench, w["config"]), mix["program"])
    read = spec.program(mix["program"]).readings
    for seed in (8100000001, 8100000002, 8100000003):
        assert judged(cell, read(cfg, mix, seed, "program", "cuda"))
        assert not judged(cell, read(cfg, mix, seed, "control", "cuda"))
