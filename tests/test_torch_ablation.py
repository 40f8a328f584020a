"""The tower ablation of the port's trainer, the twin of
``tests/test_ablation.py``: on a split-cue corpus (image-cued key sentences
read like fillers and are identifiable only through the saliency band on
their topic-matched keyframes) the image tower must recover image-cued
picks and the text-only model must not, with ``tests/test_ablation.py``'s
corpus, config, steps and thresholds, through
``mmbidaf_tpu_torch.experiments.quality_run`` on the CPU.

The frozen frontend is the JAX twin's: its random tiny-VGG weights
(``frontend_init(jax.random.key(1))``, what JAX's ``run_quality`` draws)
loaded into the port, so both twins see the same image features; the
model's weights and batch indices are the port's own draws. The image cue
is learnable from some random VGG draws and not from others: with JAX's
draw the port recovered 0.44 of the held-out image-cued keys at step 2000
and 0.50 at 2500 (JAX's probe: 0.44–0.50 from step 2000 on), with the
port's own seed-1 draw 0.25 at 2500. The steps are not cut below JAX's
2500: at 2000 the with-tower value would sit 0.09 from the 0.35
threshold, under JAX's margin of 0.1.

``ablation_sweep``'s config and CLI are also held against the JAX script's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from experiments import ablation_sweep as j_ablation
from mmbidaf_tpu.config import Config as JConfig
from mmbidaf_tpu.config import DataConfig as JDataConfig
from mmbidaf_tpu.config import ModelConfig as JModelConfig
from mmbidaf_tpu.config import TrainConfig as JTrainConfig
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY_SPEC
from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from mmbidaf_tpu_torch.examples import make_synthetic_corpus
from mmbidaf_tpu_torch.experiments import ablation_sweep, quality_run
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
def split_corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("abl") / "corpus")
    # seconds matches the featurized audio window (32*128+256 samples) so
    # no sentence's audio span is cropped by the loader
    make_synthetic_corpus.make_corpus(
        root, videos=100, sentences=8, frames=8, seconds=4352 / 16000, seed=3, n_key=2,
        learnable=True, split=16, cue_mode="split", cue_classes=("text", "image"))
    return root


def _cfg(use_images: bool, C=Config, D=DataConfig, M=ModelConfig, T=TrainConfig):
    """``tests/test_ablation.py``'s config, in either package."""
    return C(
        data=D(max_sentences=8, max_words=12, max_keyframes=8, max_audio_frames=32,
               vocab_size=256, image_size=32, n_fft=256, win_length=256, hop_length=128,
               audio_features="logmel"),
        model=M(hidden_size=24, img_feat_dim=48, audio_feat_dim=64, max_decode_steps=2,
                vgg_variant="tiny", use_images=use_images, use_audio=False),
        train=T(batch_size=8, lr=0.5),
    )


def test_split_corpus_hides_cues_from_text(split_corpus):
    """Corpus contract: image-cued key sentences use filler templates (no
    marker words), so transcript text alone cannot identify them; the
    port's ``load_split`` carries every dev video's cues."""
    train = os.path.join(split_corpus, "train")
    seen_classes = set()
    for vid in sorted(os.listdir(train)):
        vd = os.path.join(train, vid)
        with open(os.path.join(vd, "cues.json")) as f:
            cues = json.load(f)["cues"]
        with open(os.path.join(vd, "transcript.txt")) as f:
            sents = [s for s in f.read().split(". ") if s]
        for k, c in cues.items():
            seen_classes.add(c)
            marked = ("rucially" in sents[int(k)]) or ("mportantly" in sents[int(k)])
            assert marked == (c == "text"), (vid, k, c, sents[int(k)])
    assert seen_classes == {"text", "image"}
    _, dev, meta = quality_run.load_split(split_corpus, _cfg(True))
    assert len(meta["cues"]) == len(dev) == 16


def test_image_cued_picks_need_the_image_tower(split_corpus):
    """Held-out image-cue recovery: >= 0.35 with the image tower, <= 0.30
    (against ~1/7 chance) without it; both models master the text-marker
    keys, and the image tower lifts the overall pick overlap."""
    finals = {}
    for name, use_images in (("text+image", True), ("text", False)):
        cfg, j_cfg = _cfg(use_images), _cfg(use_images, JConfig, JDataConfig, JModelConfig,
                                            JTrainConfig)
        fe = jax.tree.map(np.asarray, j_frontend_init(jax.random.key(1), j_cfg,
                                                      vgg_spec=J_TINY_SPEC))
        finals[name] = quality_run.run_quality(
            cfg, split_corpus, steps=2500, batch=8, eval_every=1250, vgg_spec=TINY_SPEC, seed=0,
            log=lambda *a, **k: None, device="cpu",
            frontend=frontend_from_jax(fe, cfg, TINY_SPEC, "cpu"))["final"]
    with_img, text_only = finals["text+image"], finals["text"]
    assert with_img["recovered_text"] >= 0.85, finals
    assert text_only["recovered_text"] >= 0.85, finals
    assert with_img["recovered_image"] >= 0.35, finals
    assert text_only["recovered_image"] <= 0.30, finals
    assert with_img["pick_overlap"] > text_only["pick_overlap"], finals


@pytest.mark.parametrize("tiny", [True, False], ids=["tiny", "full"])
def test_build_cfg_matches_jax(tiny):
    """The sweep's config (tiny and full size) equals the JAX script's, but
    for the kernel flags the port turns on in full (its log-mel kernel K4
    too: the JAX script leaves ``use_pallas_melspec`` at its default)."""
    argv = ["--tiny"] if tiny else []
    ours, spec = ablation_sweep.build_cfg(ablation_sweep.parser().parse_args(argv))
    a = j_ablation.argparse.Namespace(tiny=tiny, sentences=12, frames=12, hidden=128, batch=32,
                                      lr=0.5)
    theirs, j_spec = j_ablation.build_cfg(a)
    if not tiny:
        theirs = dataclasses.replace(theirs, model=dataclasses.replace(theirs.model,
                                                                       use_pallas_melspec=True))
    assert dataclasses.asdict(ours) == json.loads(json.dumps(dataclasses.asdict(theirs)))
    assert tuple(spec) == tuple(j_spec)
    assert ablation_sweep.TOWER_CONFIGS == j_ablation.TOWER_CONFIGS


def test_sweep_cli_writes_the_table(tmp_path):
    """``main`` on the CPU at a tiny size: the corpus generated at
    ``--data_dir``, one run a tower config, and the summary JSON with the
    per-config table of the JAX script's columns."""
    out = tmp_path / "ablation.json"
    summary = ablation_sweep.main(["--tiny", "--device", "cpu", "--videos", "10", "--dev", "2",
                                   "--sentences", "6", "--frames", "4", "--keys", "2",
                                   "--steps", "3", "--eval_every", "3", "--batch", "2",
                                   "--towers", "text,trimodal", "--data_dir",
                                   str(tmp_path / "corpus"), "--out", str(out)])
    on_disk = json.loads(out.read_text())
    assert sorted(on_disk["table"]) == ["text", "trimodal"] == sorted(summary["table"])
    for row in on_disk["table"].values():
        assert set(row) == set(ablation_sweep.TABLE_KEYS)
    assert on_disk["runs"]["trimodal"]["towers"] == "text+image+audio"
    assert on_disk["steps"] == 3 and on_disk["corpus"]["cue_mode"] == "split"
