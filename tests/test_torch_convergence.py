"""Held-out convergence of the port's trainer, the twin of
``tests/test_convergence.py``: the trimodal model trained on a learnable
synthetic corpus must recover the gold picks on held-out videos, with the
same corpus, config and thresholds, through
``mmbidaf_tpu_torch.experiments.quality_run`` on the CPU (the plain
versions of the kernels). The port's batch indices come from a
``torch.Generator``, so its curve is not JAX's step for step: thresholds,
not curves, are held.

The pieces are also held against the JAX package's ``experiments/quality_run.py``:
``pick_metrics`` and ``per_cue_recovery`` on the same picks, ``load_split``
on the same corpus, and ``featurize_corpus`` with the same frontend weights
(images within ``atol=1e-5, rtol=2e-5``: f32 convolutions summed in other
orders; the MFCCs normwise, within 1e-5 of their largest magnitude: c0
reaches ~550 here, and the DCT spreads the log-mel's relative rounding at
that scale over every coefficient — 1.4e-3 measured).
"""

import numpy as np
import pytest
import torch

import jax

from experiments import quality_run as j_quality
from mmbidaf_tpu.config import Config as JConfig
from mmbidaf_tpu.config import DataConfig as JDataConfig
from mmbidaf_tpu.config import ModelConfig as JModelConfig
from mmbidaf_tpu.config import TrainConfig as JTrainConfig
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY_SPEC
from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mmbidaf_tpu_torch.examples import make_synthetic_corpus
from mmbidaf_tpu_torch.experiments import quality_run
from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC


@pytest.fixture(autouse=True)
def one_thread():
    """Hundreds of steps of a tiny model: one intra-op thread each (as fast
    alone, and the suite's workers share the host's cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def learnable_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ql") / "corpus")
    make_synthetic_corpus.make_corpus(root, videos=20, sentences=8, frames=6, seconds=2.0,
                                      seed=3, n_key=2, learnable=True, split=4)
    return root


def _cfg(C=Config, D=DataConfig, M=ModelConfig, T=TrainConfig):
    """``tests/test_convergence.py``'s config, in either package."""
    return C(
        data=D(max_sentences=8, max_words=12, max_keyframes=6, max_audio_frames=32,
               vocab_size=256, image_size=32, n_fft=256, win_length=256, hop_length=128),
        model=M(hidden_size=24, img_feat_dim=48, audio_feat_dim=40, max_decode_steps=2,
                vgg_variant="tiny"),
        train=T(batch_size=8, lr=0.5),
    )


def test_heldout_pick_accuracy_converges(learnable_corpus):
    """300 adadelta steps: held-out pick overlap must rise from the random
    floor (~0.25 for K=2 of 8) to >= 0.75, and ROUGE-L must approach the
    oracle ceiling (1.0: summaries are verbatim key sentences)."""
    final = quality_run.run_quality(_cfg(), learnable_corpus, steps=300, batch=8,
                                    eval_every=150, vgg_spec=TINY_SPEC, seed=0,
                                    log=lambda *a, **k: None, device="cpu")
    assert final["floor"]["pick_overlap"] < 0.6  # untrained = near chance
    assert final["final"]["pick_overlap"] >= 0.75, final["final"]
    assert final["final"]["ROUGE-L"] >= 0.75, final["final"]
    assert final["final"]["ROUGE-L"] <= final["oracle_ceiling"]["ROUGE-L"] + 1e-6
    assert final["final"]["train_loss"] < 1.0
    assert [r["step"] for r in final["curve"]] == [0, 150, 300]


def test_load_split_matches_jax(learnable_corpus):
    """The same train/dev split, vocabulary, dev sentences, gold summaries
    and cues as the JAX script's ``load_split``."""
    train, dev, meta = quality_run.load_split(learnable_corpus, _cfg())
    j_train, j_dev, j_meta = j_quality.load_split(
        learnable_corpus, _cfg(JConfig, JDataConfig, JModelConfig, JTrainConfig))
    assert (len(train), len(dev)) == (len(j_train), len(j_dev)) == (16, 4)
    assert train.word2idx == j_train.word2idx
    assert meta == j_meta


def test_featurize_corpus_matches_jax(learnable_corpus):
    """The dev set through the frozen frontend (JAX's weights in both) gives
    JAX's features, targets and masks."""
    cfg, j_cfg = _cfg(), _cfg(JConfig, JDataConfig, JModelConfig, JTrainConfig)
    _, dev, _ = quality_run.load_split(learnable_corpus, cfg)
    _, j_dev, _ = j_quality.load_split(learnable_corpus, j_cfg)
    fe = jax.tree.map(np.asarray, j_frontend_init(jax.random.key(1), j_cfg, vgg_spec=J_TINY_SPEC))
    ours = quality_run.featurize_corpus(dev, cfg, TINY_SPEC, "cpu", chunk=3,
                                        frontend=frontend_from_jax(fe, cfg, TINY_SPEC, "cpu"))
    theirs = j_quality.featurize_corpus(j_dev, j_cfg, J_TINY_SPEC, chunk=3)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        v = np.asarray(v)
        if k == "audio":
            np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-5 * np.abs(v).max(), rtol=0)
        else:
            np.testing.assert_allclose(ours[k].numpy(), v, atol=1e-5, rtol=2e-5, err_msg=k)


def test_batch_sampler_gathers_rows():
    feats = {"a": torch.arange(10.0)[:, None].expand(10, 3), "b": torch.arange(10)}
    sample = quality_run.make_batch_sampler(feats, 4)
    out = sample(feats, torch.Generator().manual_seed(0))
    assert out["a"].shape == (4, 3) and out["b"].shape == (4,)
    torch.testing.assert_close(out["a"][:, 0], out["b"].float())
    again = sample(feats, torch.Generator().manual_seed(0))
    assert torch.equal(again["b"], out["b"])


def test_pick_metrics_shapes():
    picks = np.array([[1, 3], [0, 2]])
    targets = np.array([[1, 3], [5, 6]])
    mask = np.array([[1.0, 1.0], [1.0, 0.0]])
    m = quality_run.pick_metrics(picks, targets, mask)
    assert m["pick_overlap"] == pytest.approx(0.5)  # (2/2 + 0/1) / 2
    assert m["pick_exact"] == pytest.approx(0.5)
    assert m["n"] == 2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pick_metrics_and_cue_recovery_match_jax(seed):
    """On the same random picks, gold targets (an empty row included) and
    per-sentence cues, both metrics equal the JAX script's."""
    rng = np.random.default_rng(seed)
    B, K, T = 9, 3, 12
    picks = rng.integers(0, T, size=(B, K))
    targets = rng.integers(0, T, size=(B, K))
    mask = (np.arange(K)[None] < rng.integers(0, K + 1, size=B)[:, None]).astype(np.float32)
    cues = [{int(k): str(rng.choice(["text", "image", "audio"]))
             for k in rng.choice(T, size=rng.integers(0, 4), replace=False)} for _ in range(B)]
    assert quality_run.pick_metrics(picks, targets, mask) == j_quality.pick_metrics(picks, targets,
                                                                                    mask)
    assert quality_run.per_cue_recovery(picks, cues) == j_quality.per_cue_recovery(picks, cues)
