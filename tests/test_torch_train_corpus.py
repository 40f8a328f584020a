"""The port's trainer on a real on-disk corpus, on the CPU: the raw-batch
train step against the JAX package's, and ``train.cli --data_dir`` (eval
with real ROUGE, resume, SIGTERM, warm start, epochs, buckets, grain,
prefetch), then ``Summarizer.from_run`` serving the run.

The corpus comes from ``examples/make_synthetic_corpus.py::make_corpus``
with a ``train/`` and ``dev/`` split. The step test carries the JAX
weights across (``interop.from_jax``, the frontend too) and runs at
drop_prob 0, held to ``tests/test_torch_train.py``'s tolerances for
``test_train_step_matches_jax``: loss and grad norm ``rtol=1e-5``, every
parameter and EMA leaf ``atol=1e-6`` after two adadelta steps. The frontend
adds no looser bound: its features enter the model as constants, and both
packages compute them in f32.
"""

import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmbidaf_tpu.config import tiny_test_config as j_tiny_config
from mmbidaf_tpu.data.frontend import frontend_init as j_frontend_init
from mmbidaf_tpu.data.synthetic import random_word_vectors as j_word_vectors
from mmbidaf_tpu.models.mmbidaf import mmbidaf_init as j_init
from mmbidaf_tpu.ops.vgg import TINY_SPEC as J_TINY
from mmbidaf_tpu.train import loop as j_loop
from mmbidaf_tpu_torch.config import tiny_test_config
from mmbidaf_tpu_torch.data.frontend import apply_frontend, frontend_init
from mmbidaf_tpu_torch.data.pipeline import VideoCorpus, collate
from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir
from mmbidaf_tpu_torch.interop.from_jax import flatten_pytree, frontend_from_jax, train_state_from_jax
from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC
from mmbidaf_tpu_torch.train import cli, loop
from mmbidaf_tpu_torch.train.checkpoint import load_config

REPO = Path(__file__).resolve().parents[1]


def _with_audio_width(cfg, **train):
    """Raw audio featurizes to n_mfcc coefficients, the tiny VGG to
    img_feat_dim: the model's audio width must be n_mfcc."""
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, audio_feat_dim=cfg.data.n_mfcc),
        train=dataclasses.replace(cfg.train, **train))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 training and 2 dev videos, 3-8 sentences each."""
    spec = importlib.util.spec_from_file_location(
        "make_synthetic_corpus", REPO / "examples" / "make_synthetic_corpus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    root = tmp_path_factory.mktemp("corpus")
    mod.make_corpus(str(root), videos=10, sentences=8, ragged=True, frames=5, seconds=0.3,
                    seed=3, split=2)
    return root


def _raw_batch(corpus_root, cfg, n=4):
    w2i = vocab_from_corpus_dir(str(corpus_root / "train"), max_size=cfg.data.vocab_size)
    vc = VideoCorpus(str(corpus_root / "train"), cfg, w2i, require_summary=True)
    nb = collate([vc[i] for i in range(n)])
    assert "frames" in nb and "waveform" in nb
    return nb


# ---------------------------------------------------------------------------
# The raw-batch train step.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_raw_train_step_matches_jax(corpus, accum):
    """Two steps of ``make_train_step(cfg, frontend, TINY_SPEC)`` on a raw
    corpus batch against JAX's ``make_train_step(cfg, fe_params=…,
    vgg_spec=TINY_SPEC)``: the frontend runs inside both steps (per
    microbatch under accumulation)."""
    j_cfg = _with_audio_width(j_tiny_config(), grad_accum_steps=accum)
    cfg = _with_audio_width(tiny_test_config(), grad_accum_steps=accum)
    nb = _raw_batch(corpus, cfg)
    rng = np.random.default_rng(0)
    params = j_init(jax.random.key(0), j_cfg,
                    jnp.asarray(j_word_vectors(rng, cfg.data.vocab_size, cfg.model.emb_dim)))
    fe = j_frontend_init(jax.random.key(1), j_cfg, vgg_spec=J_TINY)
    j_state = j_loop.init_train_state(jax.random.key(1), params, j_cfg)
    j_step = j_loop.make_train_step(j_cfg, fe_params=fe, vgg_spec=J_TINY)
    state = train_state_from_jax(_np(params), _np(params), cfg, device="cpu")
    step = loop.make_train_step(cfg, frontend_from_jax(_np(fe), cfg, TINY_SPEC, device="cpu"),
                                TINY_SPEC)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    for _ in range(2):
        j_state, j_m = j_step(j_state, jb)
        state, m = step(state, tb)
        np.testing.assert_allclose(float(m["loss"]), float(j_m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-5)
    assert state.step == int(j_state.step) == 2
    for tree, module in ((j_state.params, state.params), (j_state.ema_params, state.ema_params)):
        ours = module.state_dict()
        for k, v in flatten_pytree(_np(tree)).items():
            np.testing.assert_allclose(ours[k].detach().numpy(), v, atol=1e-6, err_msg=k)


def test_raw_step_draws_nothing_from_the_generator(corpus):
    """At drop_prob 0.2 a step on the raw batch equals, bit for bit, a step
    from the same state on the batch featurized beforehand: the frontend
    inside the step draws no dropout mask."""
    cfg = _with_audio_width(tiny_test_config())
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, drop_prob=0.2))
    nb = {k: torch.from_numpy(v) for k, v in _raw_batch(corpus, cfg).items()}
    fe = frontend_init(cfg, TINY_SPEC, "cpu", seed=3)
    with torch.no_grad():
        feat = apply_frontend(fe, nb, cfg, TINY_SPEC)
    feat["targets"], feat["target_mask"] = nb["targets"], nb["target_mask"]
    wv = np.random.default_rng(1).standard_normal((cfg.data.vocab_size, cfg.model.emb_dim))
    runs = []
    for batch, frontend in ((nb, fe), (feat, None)):
        state = loop.init_train_state(mmbidaf_init(cfg, wv.astype(np.float32), "cpu", seed=0),
                                      cfg, seed=1)
        step = loop.make_train_step(cfg, frontend, TINY_SPEC)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        runs.append((losses, {k: v.clone() for k, v in state.params.state_dict().items()}))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    with pytest.raises(ValueError, match="frontend"):
        loop.make_train_step(cfg)(state, nb)


# ---------------------------------------------------------------------------
# The CLI on the corpus.
# ---------------------------------------------------------------------------


def _args(corpus, tmp, name, *extra):
    cfg = _with_audio_width(tiny_test_config(), eval_steps=3)
    path = Path(tmp) / "tiny.json"
    if not path.exists():
        path.write_text(json.dumps(dataclasses.asdict(cfg)))
    return ["--data_dir", str(corpus), "--vgg", "tiny", "--config_json", str(path),
            "--device", "cpu", "--save_dir", str(tmp), "--name", name, *extra]


def _final_params(run_dir):
    index = json.loads((run_dir / "ckpts" / "index.json").read_text())
    step = max(int(s) for s in index)
    return step, torch.load(run_dir / "ckpts" / f"step_{step}.pt", weights_only=True)


def _logs(run_dir):
    return [json.loads(line) for line in (run_dir / "log.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def run_a(corpus, tmp_path_factory):
    """Six steps with evals at 3 and 6; the trainer's eval picks recorded."""
    tmp = tmp_path_factory.mktemp("runs")
    picks = []

    def recording(cfg, audio_g_fn=None):
        inner = make_eval_step(cfg, audio_g_fn)

        def eval_step(params, batch):
            out = inner(params, batch)
            picks.append(out["picks"].numpy().copy())
            return out

        return eval_step

    make_eval_step = loop.make_eval_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(loop, "make_eval_step", recording)
        cli.main(_args(corpus, tmp, "a", "--num_steps", "6"))
    return tmp, tmp / "a", picks


def test_cli_data_dir_trains_evaluates_and_saves_the_run(run_a):
    _, run, picks = run_a
    assert (run / "vocab.json").exists() and (run / "emb.npz").exists()
    assert load_config(run).model.vgg_variant == "tiny"
    index = json.loads((run / "ckpts" / "index.json").read_text())
    assert set(index) == {"3", "6"} and all("ROUGE-L" in m for m in index.values())
    logs = _logs(run)
    evals = [r for r in logs if "eval_loss" in r]
    assert [r["step"] for r in evals] == [3, 6]
    assert all(0.0 < r["ROUGE-L"] <= 1.0 and np.isfinite(r["eval_loss"]) for r in evals)
    last = [r for r in logs if "loss" in r][-1]
    assert last["step"] == 6 and np.isfinite(last["loss"])
    assert {"pad_frac", "pad_frac_word", "pad_frac_img", "pad_frac_aud"} <= set(last)
    assert len(picks) == 2 and picks[0].shape == (4, 3)


def test_cli_rerun_resumes_with_the_same_data_order(corpus, run_a, capsys):
    """Three steps, then a rerun to six: the final parameters, EMA and
    optimizer state equal, bit for bit, those of six steps in one run."""
    tmp, run, _ = run_a
    cli.main(_args(corpus, tmp, "b", "--num_steps", "3"))
    cli.main(_args(corpus, tmp, "b", "--num_steps", "6"))
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "data stream fast-forwarded 3 batches" in out
    (sa, a), (sb, b) = _final_params(run), _final_params(tmp / "b")
    assert sa == sb == 6
    for part in ("params", "ema_params"):
        assert all(torch.equal(a[part][k], b[part][k]) for k in a[part]), part
    assert all(torch.equal(x, y) for x, y in zip(a["opt_state"]["e_g"], b["opt_state"]["e_g"]))


def test_cli_prefetch_gives_the_same_losses(corpus, run_a):
    tmp, run, _ = run_a
    cli.main(_args(corpus, tmp, "p", "--num_steps", "6", "--prefetch", "2"))
    for key in ("loss", "eval_loss", "ROUGE-L"):
        assert [r.get(key) for r in _logs(run)] == [r.get(key) for r in _logs(tmp / "p")], key
    (_, a), (_, b) = _final_params(run), _final_params(tmp / "p")
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])


def test_from_run_serves_the_trainers_eval_picks(corpus, run_a):
    """``Summarizer.from_run`` with the run's seed (the frontend seeded as
    the trainer seeded it) picks on the dev videos what the trainer's last
    EMA eval picked on its dev batch."""
    from mmbidaf_tpu_torch.serving import Summarizer

    _, run, picks = run_a
    cfg = load_config(run)
    s = Summarizer.from_run(str(run), seed=cfg.train.seed, device="cpu")
    dev = sorted(str(p) for p in (corpus / "dev").iterdir())
    raw, _ = s._raw_batch(dev)
    np.testing.assert_array_equal(s._decode_batch(raw), picks[-1][:len(dev)])
    assert all(isinstance(x, str) and x for x in s.summarize_batch(dev))
    # a layout chosen at deploy time: the classifier split over a 1-wide
    # model axis on one process is the plain path, bit for bit
    tp = Summarizer.from_run(str(run), mesh_overrides={"tp_vgg": True}, seed=cfg.train.seed,
                             device="cpu")
    np.testing.assert_array_equal(tp._decode_batch(raw), picks[-1][:len(dev)])
    with pytest.raises(TypeError):
        Summarizer.from_run(str(run), mesh_overrides={"bogus_axis": 3}, device="cpu")
    with pytest.raises(FileNotFoundError):
        Summarizer.from_checkpoint(str(run / "none"), str(run / "vocab.json"),
                                   str(run / "emb.npz"), cfg, TINY_SPEC, device="cpu")


def test_cli_warm_start_takes_params_with_a_fresh_step(corpus, run_a, capsys):
    tmp, run, _ = run_a
    args = _args(corpus, tmp, "w", "--num_steps", "2", "--load_path", str(run / "ckpts"))
    cli.main(args)
    out = capsys.readouterr().out
    assert "warm-started params from" in out and "(source step 6)" in out
    assert "resumed from step" not in out
    index = json.loads((tmp / "w" / "ckpts" / "index.json").read_text())
    assert set(index) == {"2"}
    cli.main(args[:-3] + ["3", "--load_path", str(run / "ckpts")])  # its own checkpoint wins
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "warm-started" not in out


def test_cli_num_epochs_sets_the_step_count(corpus, tmp_path, capsys):
    cli.main(_args(corpus, tmp_path, "e", "--num_epochs", "2"))
    assert "training 2 epochs x 2 steps/epoch = 4 steps" in capsys.readouterr().out
    assert _final_params(tmp_path / "e")[0] == 4


def test_cli_auto_buckets_log_padding(corpus, tmp_path, capsys):
    cli.main(_args(corpus, tmp_path, "k", "--num_steps", "2", "--buckets", "auto"))
    assert "auto buckets: sentences=" in capsys.readouterr().out
    last = _logs(tmp_path / "k")[-1]
    assert last["step"] == 2 and {"pad_frac_word", "pad_frac_img", "pad_frac_aud"} <= set(last)


def test_cli_grain_loader_state_resume(corpus, tmp_path, capsys, monkeypatch):
    """``--loader_workers`` trains through grain, saves its iterator state
    beside every checkpoint and restores it on resume. The loader decodes
    in-process here (``worker_count=0``): a grain worker process takes tens
    of seconds to deliver its first batch on a small CPU host."""
    pytest.importorskip("grain")
    from mmbidaf_tpu_torch.data import pipeline

    make = pipeline.make_grain_loader
    monkeypatch.setattr(pipeline, "make_grain_loader",
                        lambda *a, **kw: make(*a, **{**kw, "worker_count": 0}))
    args = _args(corpus, tmp_path, "g", "--loader_workers", "1")
    cli.main(args + ["--num_steps", "4"])
    assert "saved final state at step 4" in capsys.readouterr().out
    assert (tmp_path / "g" / "loader_state.bin.step").read_text() == "4"
    cli.main(args + ["--num_steps", "5"])
    assert "grain loader state restored at step 4" in capsys.readouterr().out


def test_grain_state_restores_or_translates(corpus, tmp_path, capsys):
    """``restore_grain_state``: the saved state at the saved step restores;
    under another worker count it is translated (grain refuses it as is);
    at another step the order restarts."""
    pytest.importorskip("grain")
    from mmbidaf_tpu_torch.data.pipeline import make_grain_loader

    cfg = _with_audio_width(tiny_test_config())
    w2i = vocab_from_corpus_dir(str(corpus / "train"))
    vc = VideoCorpus(str(corpus / "train"), cfg, w2i, require_summary=True)
    it = iter(make_grain_loader(vc, 2, 0))
    next(it)
    next(it)
    (tmp_path / "loader_state.bin").write_bytes(it.get_state())
    (tmp_path / "loader_state.bin.step").write_text("2")
    want = next(it)
    fresh = iter(make_grain_loader(vc, 2, 0))
    cli.restore_grain_state(fresh, 2, 0, 2, str(tmp_path))
    assert "restored at step 2" in capsys.readouterr().out
    assert np.array_equal(next(fresh)["text_ids"], want["text_ids"])
    other = iter(make_grain_loader(vc, 2, 0, worker_count=2))  # no batch read: no worker starts
    cli.restore_grain_state(other, 2, 2, 2, str(tmp_path))
    assert "translated to worker_count=2" in capsys.readouterr().out
    assert json.loads(other.get_state())["worker_count"] == 2
    cli.restore_grain_state(iter(make_grain_loader(vc, 2, 0)), 3, 0, 2, str(tmp_path))
    assert "data order restarts" in capsys.readouterr().out


def test_cli_sigterm_saves_and_resumes(corpus, tmp_path, capsys):
    """SIGTERM to a training process: an unranked save, the message, exit 0;
    the next run resumes from the saved step."""
    args = _args(corpus, tmp_path, "s", "--num_steps", "100000", "--eval_steps", "2")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    proc = subprocess.Popen([sys.executable, "-m", "mmbidaf_tpu_torch.train.cli", *args],
                            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    index = tmp_path / "s" / "ckpts" / "index.json"
    deadline = time.time() + 120
    while not index.exists() and time.time() < deadline:
        assert proc.poll() is None, proc.stderr.read()[-2000:]
        time.sleep(0.1)
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-2000:]
    assert "preempted (signal 15): saved step" in out, out[-2000:]
    saved = int(out.split("preempted (signal 15): saved step")[1].split(";")[0])
    assert saved >= 2 and str(saved) in json.loads(index.read_text())
    cli.main(args[:-4] + ["--num_steps", str(saved + 1)])
    out = capsys.readouterr().out
    assert f"resumed from step {saved}" in out and "done" in out


def test_cli_mesh_layouts_raise(corpus, tmp_path):
    """A layout asking for more devices than processes raises, as JAX's
    ``make_mesh`` does (nothing falls back to one device), and so do
    ``train.py``'s flag checks; the layouts run on one process at axis size 1
    (``tests/test_torch_parallel_cli.py`` runs them across processes)."""
    for flag in (["--num_seq", "2"], ["--num_model", "2"], ["--num_data", "2"]):
        with pytest.raises(ValueError, match="2 devices, have 1"):
            cli.main(_args(corpus, tmp_path, "m", "--num_steps", "1", *flag))
    with pytest.raises(SystemExit, match="multiples of --num_seq 2"):
        cli.main(_args(corpus, tmp_path, "m", "--num_steps", "1", "--sp_audio", "--num_seq", "2",
                       "--buckets", "4", "--aud_buckets", "3"))
    path = tmp_path / "mesh.json"
    path.write_text(json.dumps({"mesh": {"sp_audio": True, "num_seq": 2}}))
    with pytest.raises(SystemExit, match="needs raw waveform batches"):
        cli.main(["--config_json", str(path), "--device", "cpu", "--num_steps", "1",
                  "--save_dir", str(tmp_path)])


def test_build_config_matches_train_py():
    """``build_config`` gives ``train.py``'s config for the same flags, with
    and without a config JSON."""
    spec = importlib.util.spec_from_file_location("train", REPO / "train.py")
    j_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_train)
    argv = ["--hidden_size", "24", "--max_decode_steps", "3", "--no_audio", "--max_words", "9",
            "--batch_size", "8", "--metric_name", "ROUGE-L", "--load_path", "x",
            "--max_checkpoints", "2", "--lr", "0.1"]
    for extra in ([], ["--config_json", str(REPO / "examples" / "tiny_config.json")]):
        ours = cli.build_config(*cli.parse_args(argv + extra))
        old = sys.argv
        sys.argv = ["train.py", *argv, *extra]
        try:
            theirs = j_train.build_config(*j_train.parse_args())
        finally:
            sys.argv = old
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs), extra


# ---------------------------------------------------------------------------
# The port's ROUGE: no rouge_score or NLTK on a CUDA host.
# ---------------------------------------------------------------------------

# Words that take each of the Porter steps' rules, and NLTK's irregular forms.
PORTER_WORDS = (
    "caresses ponies ties caress cats feed agreed plastered bled motoring sing conflated "
    "troubled sized hopping tanned falling hissing fizzed failing filing happy sky relational "
    "conditional rational valenci hesitanci digitizer conformabli radicalli differentli vileli "
    "analogousli vietnamization predication operator feudalism decisiveness hopefulness "
    "callousness formaliti sensitiviti sensibiliti triplicate formative formalize electriciti "
    "electrical hopeful goodness revival allowance inference airliner gyroscopic adjustable "
    "defensible irritant replacement adjustment dependent adoption homologou communism "
    "activate angulariti homologous effective bowdlerize probate rate cease controll roll "
    "dying lying tying skies news innings outings cannings howe proceed exceed succeed "
    "generously fully logi archaeology analogies died tied lies spied cried yyyy abbey "
    "carefulli generalli")


def _doc_words():
    import re

    words = set(PORTER_WORDS.split())
    for path in sorted(REPO.glob("*.md")) + sorted((REPO / "mmbidaf_tpu").rglob("*.py")):
        words |= set(re.findall(r"[a-z0-9]+", path.read_text(errors="ignore").lower()))
    return sorted(words)


def test_porter_stems_match_nltk():
    """Every word of the repository's documents and the JAX package's source
    (several thousand) and each rule's examples stem as NLTK stems them."""
    porter = pytest.importorskip("nltk.stem.porter")
    from mmbidaf_tpu_torch.train.rouge import porter_stem

    stemmer = porter.PorterStemmer()
    words = _doc_words()
    assert len(words) > 3000
    assert [porter_stem(w) for w in words] == [stemmer.stem(w) for w in words]


def test_rouge_matches_rouge_score():
    """ROUGE-1/2/L of random texts over those words (punctuation, case and
    empty texts included) equal ``rouge_score``'s, exactly."""
    rouge_scorer = pytest.importorskip("rouge_score.rouge_scorer")
    from mmbidaf_tpu_torch.train.rouge import rouge_f

    scorer = rouge_scorer.RougeScorer(["rouge1", "rouge2", "rougeL"], use_stemmer=True)
    words = _doc_words()
    rng = np.random.default_rng(0)
    for _ in range(200):
        summary = " ".join(rng.choice(words, size=int(rng.integers(0, 30)))) + \
            str(rng.choice(["", ".", " The-END!!", " Gradient's"]))
        reference = " ".join(rng.choice(words[:150], size=int(rng.integers(0, 20)))).title()
        s = scorer.score(reference, summary)
        assert rouge_f(summary, reference) == {
            "ROUGE-1": s["rouge1"].fmeasure, "ROUGE-2": s["rouge2"].fmeasure,
            "ROUGE-L": s["rougeL"].fmeasure}
