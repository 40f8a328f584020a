"""The plain reference agrees with the program at a tiny size, in f32 where
the two compute alike."""

import copy

import pytest
import torch

from pbench import check, core, spec
from pbench.traffic import sub_seed
from reference import mmbidaf_ref as ref


def f32(cfg):
    cfg = copy.deepcopy(cfg)
    cfg["programs"]["serve"]["model"]["compute_dtype"] = "float32"
    return cfg


def test_serving_agrees(tiny):
    bench, cfg_file, mix = tiny("serve.h128.b64")
    cfg = spec.program_config(f32(cfg_file), "serve")
    w, pool = core.make_inputs(cfg, mix, 17, "cpu")
    prog = spec.program("serve").build(cfg, mix, w, 17, "cpu")
    for raw in pool:
        log_p, picks = prog.call(raw)
        ref_logp, ref_picks = ref.serve(w["model"], w["vgg"], raw, cfg)
        assert torch.equal(picks.long(), ref_picks)
        got = check.serve_numbers(log_p, picks, ref_logp, raw["sent_mask"], True)
        assert got["pick_gap"] == 0.0 and got["logp_err"] < 1e-4


def test_training_agrees(tiny):
    bench, cfg_file, mix = tiny("train.h512.b32")
    cfg = spec.program_config(cfg_file, "train")
    w, pool = core.make_inputs(cfg, mix, 23, "cpu")
    kind = spec.program("train")
    prog = kind.build(cfg, mix, w, 23, "cpu")
    prog.warm(pool)
    got = check.train_numbers(prog.record(),
                              kind.reference(cfg, w, pool, mix["check_steps"], sub_seed(23, "dropout")),
                              w["model"])
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-5 and got["change_gap"] < 1e-3


@pytest.mark.parametrize("dst, src", [(224, 320), (224, 240), (32, 48)])
def test_resize_rows_sum_to_one(dst, src):
    w = ref.resize_weights(dst, src)
    assert w.shape == (dst, src) and abs(w.sum(1) - 1).max() < 1e-12 and (w >= 0).all()
