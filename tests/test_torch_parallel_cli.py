"""``python -m mmbidaf_tpu_torch.train.cli`` across processes: a run at world
size 2 (gloo on the CPU, through ``tests/test_torch_parallel.py``'s group)
equals the run of one process on the same global batches.

- data parallelism on the synthetic stream (``--num_data 2``, drop 0.1: the
  dropout masks are drawn for the global batch and cut to each rank's rows);
- the sequence-parallel audio tower on a raw corpus (``--sp_audio --num_seq
  2``, with shape buckets whose audio rungs the ``seq`` axis divides), held
  against the single-process run without it (the SP chain's flash softmax
  and frame-split sums reorder f32 arithmetic).

Rank 0 alone writes the run: one log line a logging step, one checkpoint
index. Tolerances: losses ``rtol=1e-5``, parameters and EMA ``atol=1e-5``
after the run's steps (adam's first steps are sign-like, so a parameter
whose gradient is rounding noise may step by up to lr either way; those are
held to the sum of the learning rates).
"""

import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_parallel import spawn  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("corpus")
    mod.make_corpus(str(root), videos=10, sentences=8, ragged=True, frames=5, seconds=0.3,
                    seed=3, split=2)
    return root


def _synthetic_args(save_dir, *extra):
    return ["--config_json", str(REPO / "examples" / "tiny_config.json"), "--device", "cpu",
            "--num_steps", "4", "--eval_steps", "2", "--save_dir", str(save_dir), *extra]


def _corpus_args(corpus, save_dir, *extra):
    return ["--config_json", str(REPO / "examples" / "tiny_config.json"), "--device", "cpu",
            "--data_dir", str(corpus), "--vgg", "tiny", "--num_steps", "2", "--eval_steps", "2",
            "--buckets", "8,16", "--aud_buckets", "32,64", "--save_dir", str(save_dir), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory, corpus):
    """The same two runs at world size 2 (one gloo group) and in this process."""
    root = tmp_path_factory.mktemp("cli")
    plan = [("cli", {"args": _synthetic_args(root / "dp2", "--num_data", "2")}),
            ("cli", {"args": _corpus_args(corpus, root / "sp2", "--sp_audio", "--num_seq", "2")})]
    spawn(str(root / "group"), 2, plan)
    from mmbidaf_tpu_torch.train import cli

    cli.main(_synthetic_args(root / "one"))
    cli.main(_corpus_args(corpus, root / "one_corpus"))
    return root


def _check_runs(a: Path, b: Path, steps: int):
    logs = [[json.loads(x) for x in (d / "log.jsonl").read_text().splitlines()] for d in (a, b)]
    assert [r["step"] for r in logs[0]] == [r["step"] for r in logs[1]]  # rank 0 wrote alone
    for ra, rb in zip(*logs):
        for k in ("loss", "eval_loss"):
            if k in ra:
                np.testing.assert_allclose(ra[k], rb[k], rtol=1e-5, err_msg=k)
    assert json.loads((a / "ckpts" / "index.json").read_text()).keys() == \
        json.loads((b / "ckpts" / "index.json").read_text()).keys()
    sa, sb = (torch.load(d / "ckpts" / f"step_{steps}.pt", weights_only=False) for d in (a, b))
    lr_sum = steps * 1e-3  # tiny_config: adam at lr 1e-3
    for tree in ("params", "ema_params"):
        diffs = np.concatenate([np.abs(sa[tree][k].numpy() - v.numpy()).ravel()
                                for k, v in sb[tree].items()])
        assert np.mean(diffs <= 1e-5) >= 0.99 and diffs.max() <= 2 * lr_sum, tree


def test_cli_data_parallel_world2_equals_one_process(runs):
    """``--num_data 2``: 4 steps and 2 evals, equal to one process's run."""
    _check_runs(runs / "dp2" / "mmbidaf", runs / "one" / "mmbidaf", 4)


def test_cli_sp_audio_skips_precomputed_features(runs, corpus, tmp_path):
    """A corpus holding ``features.npz`` (``tools/precompute_features.py``):
    under ``--sp_audio`` the trainer reads the raw waveforms the SP tower
    featurizes, and its run equals one process's without the SP tower."""
    from mmbidaf_tpu_torch.tools import precompute_features
    from mmbidaf_tpu_torch.train import cli

    pre = tmp_path / "corpus"
    shutil.copytree(corpus, pre)
    precompute_features.main(["--data_dir", str(pre), "--config_json",
                              str(REPO / "examples" / "tiny_config.json"), "--vgg", "tiny",
                              "--device", "cpu"])
    assert list(pre.glob("train/*/features.npz"))
    cli.main(_corpus_args(pre, tmp_path / "sp1", "--sp_audio", "--num_seq", "1"))
    _check_runs(tmp_path / "sp1" / "mmbidaf", runs / "one_corpus" / "mmbidaf", 2)


def test_cli_sp_audio_world2_equals_one_process(runs):
    """``--sp_audio --num_seq 2`` on raw corpus batches with audio buckets
    of 32 and 64 frames: 2 steps and an eval, equal to one process's run
    without the SP tower."""
    _check_runs(runs / "sp2" / "mmbidaf", runs / "one_corpus" / "mmbidaf", 2)
