"""The port's ``infer`` CLI against the JAX package, on the CPU, and the
port's copies of ``data/benchmarks.py`` and ``data/subtitles.py``.

A corpus from ``examples/make_synthetic_corpus.py`` (split, ragged), JAX
weights carried into a port train state (``interop.from_jax``) and saved
with the port's checkpoint manager beside a ``config.json``. The images are
off, so the frontend holds no random weights and both packages featurize
the same audio. ``python -m mmbidaf_tpu_torch.infer`` must then print the
ROUGE (to 4 places) and keyshot-F1 that JAX's ``make_eval_step`` picks (or
its beam decode) give on the same dev videos, the last batch wrapping as
the reference CLI wraps it, with and without ``--bucket_eval`` and the
prefetch thread. The ROUGE on the JAX side is ``rouge_score``'s, on the
port's side its own (``train/rouge.py``).
"""

import ast
import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data import benchmarks as j_benchmarks
from mmbidaf_tpu.data import subtitles as j_subtitles
from mmbidaf_tpu.data.frontend import apply_frontend as j_apply_frontend
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.data.pipeline import VideoCorpus as JCorpus
from mmbidaf_tpu.data.pipeline import collate as j_collate
from mmbidaf_tpu.data.synthetic import random_word_vectors
from mmbidaf_tpu.data.vocab import vocab_from_corpus_dir
from mmbidaf_tpu.models.mmbidaf import mmbidaf_decode as j_decode
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu.train.loop import make_eval_step
from mmbidaf_tpu.train.metrics import batch_rouge as j_batch_rouge
from mmbidaf_tpu_torch import infer
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.data import benchmarks, subtitles
from mmbidaf_tpu_torch.interop.from_jax import train_state_from_jax
from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager, save_config

REPO = Path(__file__).resolve().parents[1]
BATCH = 2


def _tiny(make):
    cfg = make(use_images=False)
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, audio_feat_dim=cfg.data.n_mfcc, use_pallas_lstm=True,
        use_pallas_attention=True, use_pallas_melspec=True))


def _annotate(vdir: Path, rng) -> None:
    """Benchmark annotations (``importance.npy`` + ``cues.json``) over the
    video's transcript sentences, one cue a second at 2 fps."""
    from mmbidaf_tpu_torch.data.text import sent_tokenize

    sents = sent_tokenize((vdir / "transcript.txt").read_text())
    cues = [[float(i), float(i + 1), s] for i, s in enumerate(sents)]
    np.save(vdir / "importance.npy", rng.random(2 * len(sents)).astype(np.float32))
    (vdir / "cues.json").write_text(json.dumps({"fps": 2.0, "cues": cues, "budget": 0.3}))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("infer")
    corpus = root / "corpus"
    mod.make_corpus(str(corpus), videos=8, sentences=6, ragged=True, frames=2, seconds=0.5,
                    seed=0, split=3)
    rng = np.random.default_rng(1)
    for vdir in sorted((corpus / "dev").iterdir()):
        _annotate(vdir, rng)
    jcfg, cfg = _tiny(j_tiny_config), _tiny(tiny_test_config)
    w2i = vocab_from_corpus_dir(str(corpus / "train"), max_size=jcfg.data.vocab_size)
    wv = random_word_vectors(rng, len(w2i), jcfg.model.emb_dim)
    params = j_init(jax.random.key(3), jcfg, jnp.asarray(wv))
    np_params = jax.tree.map(np.asarray, params)
    state = train_state_from_jax(np_params, np_params, cfg, device="cpu")
    run_dir = root / "run"
    CheckpointManager(run_dir / "ckpts").save_unranked(state)
    save_config(run_dir, cfg)
    return {"corpus": str(corpus), "ckpts": str(run_dir / "ckpts"), "params": params,
            "jcfg": jcfg, "w2i": w2i, "root": root}


def _jax_scores(run, mode="greedy", topk=3) -> dict:
    """The reference CLI's corpus eval, in JAX: dev videos in batches whose
    tail wraps, ROUGE of the picked sentences, keyshot-F1."""
    jcfg = run["jcfg"]
    corpus = JCorpus(os.path.join(run["corpus"], "dev"), jcfg, run["w2i"], use_precomputed=True)
    fe = j_frontend_init(jax.random.key(0), jcfg, vgg_spec=J_TINY)  # audio constants only
    eval_step = make_eval_step(jcfg)
    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n_scored, ks = 0, []
    for start in range(0, len(corpus), BATCH):
        idxs = [min(start + j, len(corpus) - 1) for j in range(BATCH)]
        n_real = min(BATCH, len(corpus) - start)
        raw = {k: jnp.asarray(v) for k, v in j_collate([corpus[i] for i in idxs]).items()}
        batch = j_apply_frontend(fe, raw, jcfg, J_TINY)
        if mode == "beam":
            picks = j_decode(run["params"], batch, jcfg, mode="beam", topk=topk)[1]
        else:
            batch["targets"], batch["target_mask"] = raw["targets"], raw["target_mask"]
            picks = eval_step(run["params"], batch)["picks"]
        picks = np.asarray(picks)[:n_real]
        texts = [corpus.example_text(i) for i in idxs[:n_real]]
        scores, n_b = j_batch_rouge(picks, [t[0] for t in texts], [t[1] for t in texts])
        for k in agg:
            agg[k] += scores[k] * n_b
        n_scored += n_b
        for j in range(n_real):
            sents = texts[j][0]
            ks.append(j_benchmarks.keyshot_from_files(
                os.path.join(corpus.root, corpus.video_ids[idxs[j]]),
                [sents[p] for p in picks[j] if 0 <= p < len(sents)]))
    out = {k: round(v / n_scored, 4) for k, v in agg.items()}
    out["keyshot-F1"] = round(sum(ks) / len(ks), 4)
    return out, n_scored


def _printed(text: str) -> tuple[dict, int | None]:
    line = [ln for ln in text.splitlines() if ln.startswith("{'ROUGE-1'")][-1]
    head, _, tail = line.partition(" (")
    return ast.literal_eval(head), (int(tail.split()[0]) if tail else None)


def _infer(capsys, run, *args) -> tuple[dict, int | None]:
    infer.main(["--device", "cpu", "--load_dir", run["ckpts"], "--data_dir", run["corpus"],
                "--batch_size", str(BATCH), *args])
    return _printed(capsys.readouterr().out)


@pytest.mark.parametrize("args", [(), ("--prefetch", "0"), ("--bucket_eval",),
                                  ("--bucket_eval", "--prefetch", "0")],
                         ids=["prefetch2", "prefetch0", "bucket_eval", "bucket_eval_prefetch0"])
def test_greedy_rouge_and_keyshot_match_jax(capsys, run, args):
    want, n = _jax_scores(run)
    got, n_got = _infer(capsys, run, *args)
    assert got == want and n_got == n == 3


def test_beam_rouge_matches_jax(capsys, run):
    want, n = _jax_scores(run, mode="beam", topk=3)
    got, _ = _infer(capsys, run, "--mode", "beam", "--topk", "3", "--bucket_eval")
    assert got == want


def test_cli_subprocess_matches_jax(run):
    """``python -m mmbidaf_tpu_torch.infer`` as a user runs it."""
    want, _ = _jax_scores(run)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    r = subprocess.run([sys.executable, "-m", "mmbidaf_tpu_torch.infer", "--device", "cpu",
                        "--load_dir", run["ckpts"], "--data_dir", run["corpus"],
                        "--batch_size", str(BATCH), "--print_summaries"],
                       capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "loaded step 0" in r.stdout and "loaded config from" in r.stdout
    assert _printed(r.stdout)[0] == want
    assert sum(": " in ln and ln.startswith("video") for ln in r.stdout.splitlines()) == 3


def test_bucket_ladders_file(capsys, run, tmp_path):
    want, _ = _jax_scores(run)
    path = tmp_path / "ladders.json"
    path.write_text(json.dumps({"sentences": [2, 4], "audio_frames": [5]}))
    got, _ = _infer(capsys, run, "--bucket_eval", "--bucket_ladders", str(path))
    assert got == want


@pytest.mark.parametrize("args", [("--long",), ("--long", "--mode", "beam", "--bucket_eval"),
                                  ("--mode", "topk", "--topk", "2")],
                         ids=["long", "long_beam_buckets", "topk"])
def test_long_and_topk_answer(capsys, run, args):
    got, n = _infer(capsys, run, *args)
    assert n == 3
    assert all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in got.values())
    assert "keyshot-F1" in got


def test_synthetic_stream(capsys):
    for mode in ("greedy", "beam", "topk"):
        infer.main(["--device", "cpu", "--config_json", str(REPO / "examples" / "tiny_config.json"),
                    "--num_batches", "2", "--batch_size", "3", "--mode", mode])
        got, n = _printed(capsys.readouterr().out)
        assert n is None and set(got) == {"ROUGE-1", "ROUGE-2", "ROUGE-L"}
        assert all(math.isfinite(v) for v in got.values())


def test_checks_before_any_load(run, tmp_path):
    base = ["--device", "cpu", "--load_dir", run["ckpts"]]
    bad = tmp_path / "bad.json"
    for ladders, msg in (({"frames": [2]}, "unknown axes"), ({"words": [0]}, "integers >= 1"),
                         ([4, 8], "non-empty JSON dict")):
        bad.write_text(json.dumps(ladders))
        with pytest.raises(SystemExit, match=msg):
            infer.main(base + ["--data_dir", run["corpus"], "--bucket_eval",
                               "--bucket_ladders", str(bad)])
    with pytest.raises(SystemExit, match="--data_dir"):
        infer.main(base + ["--bucket_eval"])
    with pytest.raises(SystemExit, match="pass both"):
        infer.main(base + ["--data_dir", run["corpus"], "--bucket_ladders", str(bad)])
    with pytest.raises(SystemExit, match="--long requires"):
        infer.main(base + ["--long"])
    with pytest.raises(SystemExit, match="no checkpoint"):
        infer.main(["--device", "cpu", "--load_dir", str(tmp_path / "none"),
                    "--config_json", str(REPO / "examples" / "tiny_config.json")])
    # --artifact scores a corpus, and the artifact fixes the model's flags
    with pytest.raises(SystemExit, match="pass --data_dir"):
        infer.main(["--device", "cpu", "--artifact", "x"])
    for flags, name in ((base, "--load_dir"), (["--device", "cpu", "--mode", "beam"], "--mode"),
                        (["--device", "cpu", "--vgg", "tiny"], "--vgg")):
        with pytest.raises(SystemExit, match=f"{name} is fixed inside the artifact"):
            infer.main(flags + ["--artifact", "x", "--data_dir", run["corpus"]])
    for flags in (["--sp_audio", "1"], ["--num_seq", "2"], ["--tp_vgg", "1"], ["--num_model", "2"]):
        with pytest.raises(NotImplementedError):
            infer.main(base + flags)


def test_infer_defaults_to_the_card():
    assert infer.parse_args([]).device == "cuda"


# -- data/benchmarks.py and data/subtitles.py: the port's copies ----------------

SRT = """1
00:00:01,000 --> 00:00:04,000
Welcome to the lecture on attention.

2
00:00:04,500 --> 00:00:07,250
<i>Today we cover</i> bidirectional flow.

3
00:00:08,000 --> 00:00:09,000
PROFESSOR: Questions are welcome.
"""

VTT = """WEBVTT

NOTE this block is metadata and must be skipped

00:00:01.000 --> 00:00:04.000
Welcome to the lecture on attention.

cue-2
00:00:04.500 --> 00:00:07.250
Today we cover bidirectional flow.

00:00:07.500 --> 00:00:08.000
Today we cover bidirectional flow.
"""

CUES = [
    (0.0, 2.0, "Low importance opening."),
    (2.0, 4.0, "The key highlight moment."),
    (4.0, 6.0, "Another dull stretch."),
    (100.0, 102.0, "Overrun caption past the video end."),
]


@pytest.mark.parametrize("text", [SRT, VTT, "", "WEBVTT\n\n"], ids=["srt", "vtt", "empty", "header"])
def test_subtitles_match_jax(text):
    assert subtitles.parse_cues(text) == j_subtitles.parse_cues(text)
    assert subtitles.subtitles_to_transcript(text) == j_subtitles.subtitles_to_transcript(text)


def test_benchmark_alignment_matches_jax():
    fps = 2.0
    scores = np.array([1, 1, 1, 1, 5, 5, 5, 5, 1, 1, 1, 1], np.float32)
    np.testing.assert_array_equal(benchmarks.cue_importance(CUES, scores, fps),
                                  j_benchmarks.cue_importance(CUES, scores, fps))
    cue_scores = np.array([1.0, 5.0, 1.0, 2.3], np.float32)
    for budget in (0.15, 0.6, 1.0):
        assert (benchmarks.select_summary_cues(CUES, cue_scores, budget)
                == j_benchmarks.select_summary_cues(CUES, cue_scores, budget))
        assert (benchmarks.summary_from_importance(CUES, scores, fps, budget)
                == j_benchmarks.summary_from_importance(CUES, scores, fps, budget))
    picked = ["The key highlight moment.", "Never said this.", "Low importance opening."]
    assert benchmarks.sentence_spans(picked, CUES) == j_benchmarks.sentence_spans(picked, CUES)
    rng = np.random.default_rng(0)
    frame_scores = rng.random(40).astype(np.float32)
    for spans in ([(4.0, 5.5)], [(0.0, 1.0), (3.0, 9.5)], []):
        assert (benchmarks.keyshot_f1(spans, frame_scores, fps)
                == j_benchmarks.keyshot_f1(spans, frame_scores, fps))


def test_benchmark_loaders_match_jax(tmp_path):
    from scipy.io import savemat

    tsv = tmp_path / "anno.tsv"
    tsv.write_text("vidA\tVT\t1,1,5,5\nvidA\tVT\t3,3,3,3,3\nvidB\tGA\t2,2\n")
    ours, theirs = benchmarks.load_tvsum_anno_tsv(str(tsv)), j_benchmarks.load_tvsum_anno_tsv(str(tsv))
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])
    bad = tmp_path / "bad.tsv"
    bad.write_text("vidA\tonly-two-fields\n")
    with pytest.raises(ValueError):
        benchmarks.load_tvsum_anno_tsv(str(bad))
    for name, content in (("Cooking.mat", {"gt_score": np.array([[0.1], [0.9], [0.5]]), "FPS": 25.0}),
                          ("Jumps.mat", {"user_score": np.array([[1, 0], [1, 1], [0, 0]], np.float64)})):
        savemat(tmp_path / name, content)
        (s, fps), (js, jfps) = (benchmarks.load_summe_gt(str(tmp_path / name)),
                                j_benchmarks.load_summe_gt(str(tmp_path / name)))
        np.testing.assert_array_equal(s, js)
        assert fps == jfps
    savemat(tmp_path / "Empty.mat", {"unrelated": np.zeros(2)})
    with pytest.raises(ValueError):
        benchmarks.load_summe_gt(str(tmp_path / "Empty.mat"))


def test_tvsum_mat_matches_jax(tmp_path):
    import h5py

    p = tmp_path / "tvsum.mat"
    anno = {"vidA": np.arange(1.0, 7.0)[:, None] * np.ones((1, 2)), "vidB": np.full((5, 2), 4.0)}
    with h5py.File(p, "w") as f:
        g = f.create_group("tvsum50")
        refs_v, refs_a = [], []
        for vid, arr in anno.items():
            dv = f.create_dataset(f"/refs/{vid}_name", data=np.array([[ord(c)] for c in vid], np.uint16))
            da = f.create_dataset(f"/refs/{vid}_anno", data=arr.T if vid == "vidA" else arr)
            refs_v.append(dv.ref)
            refs_a.append(da.ref)
        dv = g.create_dataset("video", (2, 1), dtype=h5py.ref_dtype)
        da = g.create_dataset("user_anno", (2, 1), dtype=h5py.ref_dtype)
        for i, (rv, ra) in enumerate(zip(refs_v, refs_a)):
            dv[i, 0], da[i, 0] = rv, ra
    ours, theirs = benchmarks.load_tvsum_mat(str(p)), j_benchmarks.load_tvsum_mat(str(p))
    assert ours.keys() == theirs.keys() == {"vidA", "vidB"}
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


def test_keyshot_from_files_matches_jax(tmp_path):
    vdir = tmp_path / "vid"
    vdir.mkdir()
    scores = np.ones(12, np.float32)
    scores[4:8] = 5.0
    np.save(vdir / "importance.npy", scores)
    cues = [[0.0, 2.0, "Low importance opening."], [2.0, 4.0, "The key highlight moment."],
            [4.0, 6.0, "Another dull stretch."]]
    (vdir / "cues.json").write_text(json.dumps({"fps": 2.0, "cues": cues}))
    for picked, budget in ((["The key highlight moment."], 4 / 12), (["Another dull stretch."], None)):
        assert (benchmarks.keyshot_from_files(str(vdir), picked, budget)
                == j_benchmarks.keyshot_from_files(str(vdir), picked, budget))
    assert benchmarks.keyshot_from_files(str(vdir), ["The key highlight moment."], 4 / 12) == 1.0
    assert benchmarks.keyshot_from_files(str(tmp_path), ["x"]) is None
