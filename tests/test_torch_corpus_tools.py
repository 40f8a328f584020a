"""The port's corpus tools against the repository's JAX-side tools:
``tools/import_corpus.py`` and ``tools/import_benchmark.py`` (host only:
output trees equal file for file, bytes and all) and
``tools/precompute_features.py`` (the port's frontend carried across from
JAX's, features within the frontend's bounds).

No ffmpeg is needed: the media come from MJPEG-AVI files that
``data/containers.py`` writes and parses itself, the TVSum annotation is a
``.tsv`` and the SumMe ground truth a ``.mat`` written with
``scipy.io.savemat``.

Tolerances for ``features.npz``: masks equal; VGG features ``atol=1e-4``
(``tests/test_torch_ops.py::test_vgg_features_carried_weights``: O(1)
values, conv sums in other orders); MFCCs ``rtol=2e-5, atol=2e-4``
(``test_waveform_to_features``: dB values up to ~100).
"""

import dataclasses
import importlib.util
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu_torch.config import config_from_json, config_to_dict, tiny_test_config
from mmbidaf_tpu_torch.data import containers
from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir
from mmbidaf_tpu_torch.interop.from_jax import frontend_from_jax
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.tools import import_benchmark, import_corpus, precompute_features

REPO = Path(__file__).resolve().parents[1]

SRT = """1
00:00:00,000 --> 00:00:02,000
Welcome to the lecture on <i>attention</i>.

2
00:00:02,000 --> 00:00:04,500
Today we cover bidirectional flow. Questions are welcome.
"""
VTT = """WEBVTT

00:00:00.000 --> 00:00:02.000
Low importance opening remarks here.

00:00:02.000 --> 00:00:04.000
The key highlight moment everyone watches.

00:00:04.000 --> 00:00:06.000
Another dull stretch of filler content.
"""


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_tool(monkeypatch, name, args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    _jax_tool(name).main()


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def _assert_same_tree(ours: Path, theirs: Path):
    a, b = _tree(ours), _tree(theirs)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], k


def _avi(path, rng, n=6, seconds=0.5):
    frames = (rng.random((n, 24, 32, 3)) * 255).astype(np.uint8)
    wave = (rng.standard_normal(int(8000 * seconds)) * 0.2).astype(np.float32)
    containers.write_mjpeg_avi(str(path), frames, fps=12, waveform=wave, sample_rate=8000)


@pytest.mark.parametrize("no_media", [False, True], ids=["media", "no_media"])
def test_import_corpus_matches_jax(tmp_path, rng, monkeypatch, capsys, no_media):
    """srt / vtt / txt sidecars, a ``.summary.txt`` gold, an MJPEG-AVI
    video (keyframes and audio without ffmpeg) and a transcript-less video
    (skipped): both tools write the same files."""
    src = tmp_path / "src"
    src.mkdir()
    (src / "lec01.srt").write_text(SRT)
    (src / "lec01.summary.txt").write_text("Welcome to the lecture on attention.")
    _avi(src / "lec01.avi", rng)
    (src / "lec02.vtt").write_text(VTT)
    (src / "lec03.txt").write_text("A plain text transcript. It has two sentences.")
    _avi(src / "lec04.avi", rng)
    args = ["--src", str(src), "--every_n", "2", "--sample_rate", "16000"]
    args += ["--no_media"] if no_media else []
    import_corpus.main([*args, "--out", str(tmp_path / "ours")])
    assert "imported 3/4" in capsys.readouterr().out
    _run_jax_tool(monkeypatch, "import_corpus", [*args, "--out", str(tmp_path / "theirs")])
    _assert_same_tree(tmp_path / "ours", tmp_path / "theirs")
    media = (tmp_path / "ours" / "lec01" / "frames").is_dir()
    assert media != no_media and (tmp_path / "ours" / "lec01" / "audio.wav").exists() == media
    w2i = vocab_from_corpus_dir(str(tmp_path / "ours"))
    assert "attention" in w2i and "bidirectional" in w2i


@pytest.mark.parametrize("dataset", ["tvsum", "summe"])
def test_import_benchmark_matches_jax(tmp_path, rng, monkeypatch, capsys, dataset):
    """TVSum (a ``.tsv``, fps from the subtitle span or ``--fps``) and SumMe
    (``.mat`` ground truth with its FPS): transcripts, budgeted gold
    summaries, ``importance.npy``, ``cues.json`` and the media of the one
    video that has a container, equal file for file."""
    from scipy.io import savemat

    subs, vids = tmp_path / "subs", tmp_path / "videos"
    subs.mkdir()
    vids.mkdir()
    for vid in ("vidA", "vidB"):
        (subs / f"{vid}.vtt").write_text(VTT)
    _avi(vids / "vidA.avi", rng)
    if dataset == "tvsum":
        anno = tmp_path / "anno.tsv"
        anno.write_text("vidA\tVT\t" + ",".join("1 1 1 1 5 5 5 5 1 1 1 1".split()) + "\n"
                        "vidA\tVT\t" + ",".join("1 2 1 2 4 4 5 4 1 1 2 1".split()) + "\n"
                        "vidB\tGA\t" + ",".join("4 4 4 4 1 1 1 1 2 2 2 2".split()) + "\n"
                        "vidC\tGA\t1,2,3\n")
        src = ["--anno", str(anno), "--fps", "0"]
    else:
        gt = tmp_path / "GT"
        gt.mkdir()
        savemat(gt / "vidA.mat", {"gt_score": np.r_[np.ones(4), 5 * np.ones(4), np.ones(4)][:, None],
                                  "FPS": 2.0})
        savemat(gt / "vidB.mat", {"gt_score": np.r_[4 * np.ones(6), np.ones(6)][:, None],
                                  "FPS": 2.0})
        src = ["--gt_dir", str(gt)]
    args = ["--dataset", dataset, *src, "--subs", str(subs), "--videos", str(vids),
            "--every_n", "3", "--budget", "0.3"]
    import_benchmark.main([*args, "--out", str(tmp_path / "ours")])
    assert "imported 2/" in capsys.readouterr().out
    _run_jax_tool(monkeypatch, "import_benchmark", [*args, "--out", str(tmp_path / "theirs")])
    _assert_same_tree(tmp_path / "ours", tmp_path / "theirs")
    assert "key highlight" in (tmp_path / "ours" / "vidA" / "summary.txt").read_text()
    assert (tmp_path / "ours" / "vidA" / "frames").is_dir()
    assert not (tmp_path / "ours" / "vidB" / "frames").exists()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("corpus")
    mod.make_corpus(str(root), videos=5, sentences=6, ragged=True, frames=4, seconds=0.3,
                    seed=2, split=2)
    return root


def test_precompute_features_matches_jax(tmp_path, corpus, monkeypatch, capsys):
    """The port's ``precompute`` with the JAX tool's frontend carried across
    (``frontend_init(key(seed + 2))``, the tiny VGG) against the JAX tool,
    on a copy of the corpus each: the same files, keys, masks, and
    features within the frontend's bounds. Then the port's CLI skips
    what exists, ``--force`` rewrites it, and ``VideoCorpus`` serves the
    features."""
    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                             audio_feat_dim=cfg.data.n_mfcc))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(config_to_dict(cfg)))
    ours, theirs = tmp_path / "ours", tmp_path / "theirs"
    shutil.copytree(corpus, ours)
    shutil.copytree(corpus, theirs)
    seed = 5
    _run_jax_tool(monkeypatch, "precompute_features",
                  ["--data_dir", str(theirs), "--config_json", str(cfg_path), "--vgg", "tiny",
                   "--batch", "2", "--seed", str(seed)])
    from mmbidaf_tpu.config import config_from_json as j_config_from_json

    j_fe = j_frontend_init(jax.random.key(seed + 2), j_config_from_json(str(cfg_path)),
                           vgg_spec=J_TINY)
    fe = frontend_from_jax(jax.tree.map(np.asarray, j_fe), cfg, TINY_SPEC, device="cpu")
    assert precompute_features.precompute(str(ours), cfg, fe, TINY_SPEC, batch=3,
                                          log=lambda s: None) == 5
    files = sorted(p.relative_to(ours) for p in ours.rglob("features.npz"))
    assert len(files) == 5 and files == sorted(p.relative_to(theirs)
                                               for p in theirs.rglob("features.npz"))
    for f in files:
        a, b = np.load(ours / f), np.load(theirs / f)
        assert sorted(a.files) == sorted(b.files) == ["aud_mask", "audio", "images", "img_mask"]
        for k in ("img_mask", "aud_mask"):
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_allclose(a["images"], b["images"], atol=1e-4)
        np.testing.assert_allclose(a["audio"], b["audio"], rtol=2e-5, atol=2e-4)

    cli = ["--data_dir", str(ours), "--config_json", str(cfg_path), "--vgg", "tiny",
           "--device", "cpu", "--seed", str(seed)]
    precompute_features.main(cli)
    assert "for 0 videos" in capsys.readouterr().out
    precompute_features.main(cli + ["--force", "--batch", "4"])
    assert "for 5 videos" in capsys.readouterr().out
    loaded = config_from_json(str(cfg_path))
    vc = VideoCorpus(str(ours / "train"), loaded, vocab_from_corpus_dir(str(ours / "train")))
    ex = vc[0]
    assert "images" in ex and "audio" in ex and "frames" not in ex
