"""Inference CLI of the port — the counterpart of the repository's
``infer.py``: load a checkpoint, decode, score the summaries.

    python -m mmbidaf_tpu_torch.infer --load_dir runs/NAME/ckpts --data_dir corpus
    python -m mmbidaf_tpu_torch.infer --load_dir runs/NAME/ckpts --data_dir corpus \\
        --mode beam --topk 4 --bucket_eval --prefetch 2
    python -m mmbidaf_tpu_torch.infer --load_dir runs/NAME/ckpts --data_dir corpus --long
    python -m mmbidaf_tpu_torch.infer --config_json examples/tiny_config.json --device cpu
    python -m mmbidaf_tpu_torch.infer --artifact artifact/ --data_dir corpus [--long]

``--load_dir`` reads a ``train.cli`` run's checkpoints (``train/checkpoint.py``)
and the ``config.json`` beside them, and decodes with the EMA parameters.
Without ``--data_dir`` it decodes ``--num_batches`` synthetic batches and
scores the picks against the stream's targets. With ``--data_dir`` (a
corpus of per-video directories; ``train/`` and ``dev/`` when split) the
vocabulary is rebuilt from the training transcripts, every dev video is
decoded once (the last batch wraps onto the last video), the picked
transcript sentences are scored with ROUGE against ``summary.txt``, and
with keyshot-F1 where a video carries ``importance.npy`` and ``cues.json``
(``data/benchmarks.py``). ``--prefetch N`` decodes and uploads batches N
ahead in a thread and fetches each batch's picks after the next batch is
dispatched; ``--bucket_eval`` trims each batch to the rungs covering its
true lengths (``serving.trim_raw_batch``; the picks do not change);
``--long`` decodes through ``Summarizer.summarize_long``. ``--device``
defaults to the card.

``--artifact DIR`` scores a frozen artifact (``tools/export_artifact.py``)
on ``--data_dir`` through ``export.ExportedSummarizer``: its config,
vocabulary, decode mode and batch live in the artifact, so ``--load_dir``,
``--mode``, ``--config_json``, ``--vgg``, ``--bucket_eval`` and the mesh
flags are conflicts.

Not ported: the mesh flags (``--sp_audio``, ``--num_seq``, ``--tp_vgg``,
``--num_model``) raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import deque

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device


class KeyshotMeter:
    """Keyshot-F1 averaged over the videos whose directories carry the
    benchmark annotations."""

    def __init__(self):
        self.total, self.n = 0.0, 0

    def add(self, video_dir: str, picked_sentences: list[str]) -> None:
        from mmbidaf_tpu_torch.data.benchmarks import keyshot_from_files

        ks = keyshot_from_files(video_dir, picked_sentences)
        if ks is not None:
            self.total += ks
            self.n += 1

    def finalize(self, agg: dict) -> None:
        if self.n:
            agg["keyshot-F1"] = self.total / self.n


def report(agg: dict, n_scored: int | None = None) -> None:
    """The scores, rounded to 4 places, as the reference CLI prints them."""
    line = {k: round(v, 4) for k, v in agg.items()}
    if n_scored is None:
        print(line, flush=True)
    else:
        print(line, f"({n_scored} videos scored)", flush=True)


def summarizer_corpus_eval(s, corpus, use_long: bool, print_summaries: bool) -> None:
    """Decode every corpus video through a ``Summarizer`` (``summarize_long``
    with ``use_long``) and print mean ROUGE against ``summary.txt`` and
    keyshot-F1."""
    from mmbidaf_tpu_torch.data.text import sent_tokenize
    from mmbidaf_tpu_torch.train.metrics import rouge_scores

    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n_scored = 0
    keyshot = KeyshotMeter()
    for i, vid in enumerate(corpus.video_ids):
        vdir = os.path.join(corpus.root, vid)
        summary = s.summarize_long(vdir) if use_long else s.summarize(vdir)
        if print_summaries:
            print(f"{vid}: {summary}")
        keyshot.add(vdir, sent_tokenize(summary))
        _, gold = corpus.example_text(i)
        if gold:
            for k, v in rouge_scores(summary, gold).items():
                agg[k] += v
            n_scored += 1
    agg = {k: v / max(n_scored, 1) for k, v in agg.items()}
    keyshot.finalize(agg)
    report(agg, n_scored)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--load_dir", default=None, help="a train.cli run's checkpoints (runs/NAME/ckpts)")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="score a frozen artifact (export.py) on --data_dir")
    ap.add_argument("--hidden_size", type=int, default=128)
    ap.add_argument("--batch_size", type=int, default=8)
    ap.add_argument("--num_batches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=224)
    ap.add_argument("--mode", default="greedy", choices=["greedy", "topk", "beam"])
    ap.add_argument("--topk", type=int, default=4, help="top-k sample width / beam width")
    ap.add_argument("--data_dir", default=None,
                    help="corpus root of per-video dirs: decode every video and score ROUGE "
                         "against summary.txt")
    ap.add_argument("--vgg", default=None, choices=["vgg16", "vgg19", "tiny"],
                    help="frontend variant; default: the config's vgg_variant")
    ap.add_argument("--config_json", default=None, help="full Config overlay")
    ap.add_argument("--print_summaries", action="store_true")
    ap.add_argument("--long", action="store_true",
                    help="windowed decode past max_sentences (Summarizer.summarize_long); "
                         "needs --data_dir")
    ap.add_argument("--sp_audio", type=int, choices=[0, 1], default=None, help="not ported: raises")
    ap.add_argument("--num_seq", type=int, default=None, help="not ported: raises")
    ap.add_argument("--tp_vgg", type=int, choices=[0, 1], default=None, help="not ported: raises")
    ap.add_argument("--num_model", type=int, default=None, help="not ported: raises")
    ap.add_argument("--bucket_eval", action="store_true",
                    help="trim each eval batch to the quarter/half/full rungs covering its "
                         "true lengths (picks and ROUGE unchanged)")
    ap.add_argument("--bucket_ladders", default=None, metavar="FILE.json",
                    help="explicit per-axis ladders for --bucket_eval (suggest_buckets JSON)")
    ap.add_argument("--prefetch", type=int, default=2, metavar="N",
                    help="corpus eval: host decode and upload run N batches ahead in a thread, "
                         "and each batch's picks are fetched after the next batch is "
                         "dispatched (0 = serial loop)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def read_bucket_ladders(a):
    """``--bucket_eval``'s ladders (True: the defaults), checked before any
    load: axis names and rung values; the caps are checked later, against
    the config."""
    if a.bucket_eval and not a.data_dir:
        raise SystemExit("--bucket_eval trims real-corpus eval batches: pass --data_dir")
    if not a.bucket_ladders:
        return True
    if not a.bucket_eval:
        raise SystemExit("--bucket_ladders configures --bucket_eval: pass both")
    try:
        with open(a.bucket_ladders) as f:
            spec = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"--bucket_ladders {a.bucket_ladders}: {e}")
    if not isinstance(spec, dict) or not spec:
        raise SystemExit(f"--bucket_ladders {a.bucket_ladders}: expected a non-empty JSON dict "
                         "of per-axis rung lists")
    from mmbidaf_tpu_torch.serving import AXES

    unknown = sorted(set(spec) - set(AXES))
    if unknown:
        raise SystemExit(f"--bucket_ladders {a.bucket_ladders}: unknown axes {unknown}; "
                         f"expected a subset of {sorted(AXES)}")
    for key, ladder in spec.items():
        rungs = ladder if isinstance(ladder, list) else [ladder]
        if not rungs or any(not isinstance(r, int) or r < 1 for r in rungs):
            raise SystemExit(f"--bucket_ladders {a.bucket_ladders}: {key!r} needs a list of "
                             f"integers >= 1, got {ladder!r}")
    return spec


def load_infer_config(a):
    from mmbidaf_tpu_torch.config import Config, config_from_json

    run_config = (os.path.join(os.path.dirname(a.load_dir.rstrip("/")), "config.json")
                  if a.load_dir else None)
    if a.config_json:
        return config_from_json(a.config_json)
    if run_config and os.path.isfile(run_config):
        # the trainer saves its whole Config beside the checkpoints
        print(f"loaded config from {run_config}")
        return config_from_json(run_config)
    cfg = Config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, hidden_size=a.hidden_size))


def main(argv=None) -> None:
    a = parse_args(argv)
    bucket_spec = read_bucket_ladders(a)
    if a.artifact:
        artifact_eval(a)
        return
    if any(v is not None for v in (a.sp_audio, a.num_seq, a.tp_vgg, a.num_model)):
        raise NotImplementedError("the mesh layouts (--sp_audio, --num_seq, --tp_vgg, --num_model) "
                                  "are not ported yet (ROADMAP Queue 1)")
    if a.long and not a.data_dir:
        raise SystemExit("--long requires --data_dir")
    cfg = load_infer_config(a)
    mesh = cfg.mesh
    if mesh.sp_audio or mesh.tp_vgg or mesh.num_seq != 1 or mesh.num_model != 1:
        raise NotImplementedError("the config asks for a mesh layout (sp_audio, tp_vgg, num_seq, "
                                  "num_model), which is not ported yet (ROADMAP Queue 1)")
    dev = resolve_device(a.device)

    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state

    np_rng = np.random.default_rng(a.seed)
    corpus = frontend = vgg_spec = w2i = None
    if a.data_dir:
        # the training vocabulary rebuilt, so ids match the checkpoint
        from mmbidaf_tpu_torch.data.frontend import frontend_init
        from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
        from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir
        from mmbidaf_tpu_torch.ops.vgg import spec_for_variant

        vgg_spec = spec_for_variant(a.vgg or cfg.model.vgg_variant)
        vocab_dir = a.data_dir
        if os.path.isdir(os.path.join(a.data_dir, "train")):
            vocab_dir = os.path.join(a.data_dir, "train")
        decode_dir = dev_split(a.data_dir)
        w2i = vocab_from_corpus_dir(vocab_dir, max_size=cfg.data.vocab_size)
        corpus = VideoCorpus(decode_dir, cfg, w2i, use_precomputed=True)
        frontend = frontend_init(cfg, vgg_spec, dev, seed=a.seed + 2)
        wv = random_word_vectors(np_rng, len(w2i), cfg.model.emb_dim)
    else:
        wv = random_word_vectors(np_rng, cfg.data.vocab_size, cfg.model.emb_dim)
    state = init_train_state(mmbidaf_init(cfg, wv, dev, seed=a.seed), cfg, seed=a.seed + 1)
    if a.load_dir:
        from mmbidaf_tpu_torch.train.checkpoint import CheckpointManager

        # the weights alone: a run saved on another device loads here too
        step = CheckpointManager(a.load_dir).warm_start(state)
        if step is None:
            raise SystemExit(f"no checkpoint found in {a.load_dir}")
        print(f"loaded step {step}")
    params = state.ema_params

    if a.long:
        from mmbidaf_tpu_torch.serving import Summarizer

        s = Summarizer(params, frontend, w2i, cfg, vgg_spec, mode=a.mode, topk=a.topk,
                       serve_batch_size=a.batch_size,
                       serve_buckets=bucket_spec if a.bucket_eval else None)
        summarizer_corpus_eval(s, corpus, use_long=True, print_summaries=a.print_summaries)
        return

    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode

    generator = torch.Generator(dev).manual_seed(a.seed) if a.mode == "topk" else None

    @torch.inference_mode()
    def decode(batch):
        return mmbidaf_decode(params, batch, cfg, mode=a.mode, topk=a.topk, generator=generator)[1]

    if corpus is not None:
        corpus_eval(a, cfg, corpus, frontend, vgg_spec, dev, decode, bucket_spec)
    else:
        synthetic_eval(a, cfg, dev, decode)


def dev_split(data_dir: str) -> str:
    """The split a corpus is scored on: ``dev/`` (else ``train/``) where the
    corpus is split, else the root."""
    if os.path.isdir(os.path.join(data_dir, "train")):
        dev = os.path.join(data_dir, "dev")
        return dev if os.path.isdir(dev) else os.path.join(data_dir, "train")
    return data_dir


def artifact_eval(a) -> None:
    """``--artifact``: every video of the corpus's scored split through the
    frozen program. Everything about the model (config, vocabulary, decode
    mode, layout) lives in the artifact, so flags that would rebuild or
    re-parameterize it are conflicts."""
    if not a.data_dir:
        raise SystemExit("--artifact evaluates against a corpus: pass --data_dir")
    for flag, name in ((a.load_dir, "--load_dir"), (a.mode != "greedy", "--mode"),
                       (a.config_json, "--config_json"), (a.vgg, "--vgg"),
                       (a.bucket_eval, "--bucket_eval"), (a.sp_audio is not None, "--sp_audio"),
                       (a.num_seq is not None, "--num_seq"), (a.tp_vgg is not None, "--tp_vgg"),
                       (a.num_model is not None, "--num_model")):
        if flag:
            raise SystemExit(f"{name} is fixed inside the artifact — re-export it, or evaluate a "
                             "checkpoint via --load_dir without --artifact")
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
    from mmbidaf_tpu_torch.export import ExportedSummarizer

    s = ExportedSummarizer(a.artifact, device=a.device)
    corpus = VideoCorpus(dev_split(a.data_dir), s.cfg, s.word2idx, use_precomputed=False)
    print(f"artifact decode_mode={s.decoder.decode_mode} batch={s.decoder.batch_size}", flush=True)
    summarizer_corpus_eval(s, corpus, a.long, a.print_summaries)


def corpus_eval(a, cfg, corpus, frontend, vgg_spec, dev, decode, bucket_spec) -> None:
    """Every corpus video once, in order, in batches whose tail wraps onto
    the last video; the picks map back to the on-disk transcript sentences."""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, cast_vgg_weights
    from mmbidaf_tpu_torch.data.pipeline import collate
    from mmbidaf_tpu_torch.data.prefetch import DevicePrefetcher, InFlight, batch_uploader
    from mmbidaf_tpu_torch.serving import HostFetch, serving_bucket_ladders, trim_raw_batch
    from mmbidaf_tpu_torch.train.metrics import batch_rouge, summary_from_picks

    fe = cast_vgg_weights(frontend, cfg.model.compute_dtype)
    ladders = serving_bucket_ladders(cfg, bucket_spec) if a.bucket_eval else None
    uploader = batch_uploader(dev)
    bs = a.batch_size

    def host_batches():
        for start in range(0, len(corpus), bs):
            idxs = [min(start + j, len(corpus) - 1) for j in range(bs)]
            yield idxs, min(bs, len(corpus) - start), collate([corpus[i] for i in idxs])

    def upload(item):
        batch = item[2] if ladders is None else trim_raw_batch(item[2], cfg, ladders)
        return uploader(batch)

    prefetcher = None
    if a.prefetch > 0:
        prefetcher = items = DevicePrefetcher(host_batches(), upload, depth=a.prefetch)
    else:
        def claimed(up):
            return up.claim() if isinstance(up, InFlight) else up

        items = ((it, claimed(upload(it))) for it in host_batches())

    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n_scored = 0
    keyshot = KeyshotMeter()

    def consume(fetch, idxs, n_real):
        nonlocal n_scored
        picks = fetch.numpy()[:n_real]
        texts = [corpus.example_text(i) for i in idxs[:n_real]]
        scores, n_b = batch_rouge(picks, [t[0] for t in texts], [t[1] for t in texts])
        for k in agg:
            agg[k] += scores[k] * n_b
        n_scored += n_b
        for j in range(n_real):
            sents = texts[j][0]
            keyshot.add(os.path.join(corpus.root, corpus.video_ids[idxs[j]]),
                        [sents[p] for p in picks[j] if 0 <= p < len(sents)])
            if a.print_summaries:
                print(f"{corpus.video_ids[idxs[j]]}: {summary_from_picks(picks[j], sents)}")

    # each batch's picks are read after the next batch is dispatched, so the
    # device never waits on the host's ROUGE and summary assembly
    pending = deque()
    try:
        for (idxs, n_real, _), raw in items:
            with torch.inference_mode():
                batch = apply_frontend(fe, raw, cfg, vgg_spec)
            pending.append((HostFetch(decode(batch)), idxs, n_real))
            if len(pending) > 1:
                consume(*pending.popleft())
        while pending:
            consume(*pending.popleft())
    finally:
        if prefetcher is not None:
            prefetcher.close()
    agg = {k: v / max(n_scored, 1) for k, v in agg.items()}
    keyshot.finalize(agg)
    report(agg, n_scored)


def synthetic_eval(a, cfg, dev, decode) -> None:
    """``--num_batches`` synthetic batches; the picks scored against the
    stream's targets over placeholder sentences."""
    from mmbidaf_tpu_torch.data.synthetic import batch_stream
    from mmbidaf_tpu_torch.train.metrics import rouge_scores, summary_from_picks

    stream = batch_stream(a.seed, cfg, a.batch_size)
    sentences = [f"This is transcript sentence {i}." for i in range(cfg.data.max_sentences)]
    agg = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    n = 0
    for _ in range(a.num_batches):
        nb = next(stream)
        picks = decode({k: torch.from_numpy(v).to(dev) for k, v in nb.items()}).cpu().numpy()
        for b in range(picks.shape[0]):
            gold = " ".join(sentences[i] for i in nb["targets"][b])
            for k, v in rouge_scores(summary_from_picks(picks[b], sentences), gold).items():
                agg[k] += v
            n += 1
    report({k: v / max(n, 1) for k, v in agg.items()})


if __name__ == "__main__":
    main()
