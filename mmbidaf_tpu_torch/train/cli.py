"""Train MMBiDAF with the port on one device — the port of ``train.py``.

    python -m mmbidaf_tpu_torch.train.cli --num_steps 200 --save_dir runs
    python -m mmbidaf_tpu_torch.train.cli --data_dir corpus --num_epochs 30
    python -m mmbidaf_tpu_torch.train.cli --data_dir corpus --vgg tiny \\
        --config_json examples/tiny_config.json --device cpu --num_steps 20

Two data sources. By default a synthetic stream of precomputed features; its
eval runs the EMA parameters on the stream's first batch, whose sentences are
placeholder strings, so ROUGE is a pick-vs-target overlap there. With
``--data_dir`` a corpus of per-video asset directories (``frames/``,
``audio.wav``, ``transcript.txt``, ``summary.txt``; ``train/`` and ``dev/``
subdirectories when present): the vocabulary comes from the training
transcripts (GloVe vectors with ``--glove_path``, else seeded random ones),
batches are raw frames and waveforms, and the frozen VGG + MFCC frontend
(``--vgg``, seeded from ``seed + 2``) runs inside the train step. Batches come
from the plain iterator, the shape buckets (``--buckets``, all four ragged
axes) or grain (``--loader_workers``, where grain is installed), optionally
through a prefetch thread (``--prefetch``). The eval featurizes every dev
video once, up front, and scores ROUGE of the picked transcript sentences
against ``summary.txt``. The run saves ``vocab.json`` / ``emb.npz`` and the
VGG variant, so ``serving.Summarizer.from_run`` serves it.

Writes ``<save_dir>/<name>/``: ``config.json``, ``log.jsonl`` (train loss,
grad norm, lr, steps/s and the padding shares every 50 steps and at the last;
eval loss and ROUGE at every ``eval_steps``), the same scalars as a
tensorboard event file under ``tb/``, and ``ckpts/`` (ranked by
``--metric_name`` at each eval, plus unranked resume points). ``--num_steps``
counts the run's total steps. A rerun with the same ``--save_dir`` and
``--name`` resumes from the newest checkpoint, the data stream fast-forwarded
to the same batch (grain's own iterator state, saved beside every checkpoint,
where grain loads). ``--load_path`` warm-starts a new run from another run's
``ckpts/``. SIGTERM or SIGINT saves an unranked checkpoint and returns.

Not ported yet: the mesh flags (``--num_seq``, ``--sp_audio``,
``--num_model``, ``--tp_vgg``, and the same fields of a ``--config_json``
raise ``NotImplementedError``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import signal
import time

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import Config, config_from_json

_MODEL_KEYS = ("hidden_size", "num_rnn_layers", "drop_prob", "max_decode_steps")
_DATA_KEYS = ("max_sentences", "max_words")
_MESH_KEYS = ("num_seq", "sp_audio", "num_model", "tp_vgg")
_TRAIN_KEYS = ("batch_size", "lr", "optimizer", "max_grad_norm", "grad_accum_steps",
               "remat_towers", "ema_decay", "l2_wd", "eval_steps", "seed", "save_dir",
               "load_path", "name", "max_checkpoints", "metric_name")
LOG_EVERY = 50


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden_size", type=int, default=128)
    ap.add_argument("--num_rnn_layers", type=int, default=1)
    ap.add_argument("--drop_prob", type=float, default=0.2)
    ap.add_argument("--max_decode_steps", type=int, default=4)
    ap.add_argument("--no_images", action="store_true")
    ap.add_argument("--no_audio", action="store_true")
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--num_steps", type=int, default=None,
                    help="total train steps; default: --num_epochs epochs over the corpus "
                         "(--data_dir), else 1000")
    ap.add_argument("--num_epochs", type=int, default=None,
                    help="with --data_dir and no --num_steps (default TrainConfig.num_epochs)")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help="prefetch depth: a thread collates and uploads the next batches "
                         "on a side CUDA stream (0 = off)")
    ap.add_argument("--loader_workers", type=int, default=0,
                    help="grain DataLoader worker processes for --data_dir (0 = decode "
                         "in-process with the plain iterator); needs grain")
    ap.add_argument("--max_eval_videos", type=int, default=256,
                    help="cap on dev videos kept featurized for eval")
    ap.add_argument("--buckets", default=None,
                    help="T_sent buckets (e.g. 16,32,64) for --data_dir; also buckets W, "
                         "T_img and T_aud per batch (quarter/half/full ladders unless "
                         "overridden). 'auto' derives all four from the corpus's length "
                         "quantiles; 'off' keeps static shapes")
    ap.add_argument("--word_buckets", default=None, help="W buckets; 'off' = static")
    ap.add_argument("--img_buckets", default=None, help="T_img buckets; 'off' = static")
    ap.add_argument("--aud_buckets", default=None, help="T_aud buckets; 'off' = static")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--optimizer", default="adadelta", choices=["adadelta", "adam"])
    ap.add_argument("--max_grad_norm", type=float, default=5.0)
    ap.add_argument("--grad_accum_steps", type=int, default=1)
    ap.add_argument("--remat_towers", action="store_true")
    ap.add_argument("--ema_decay", type=float, default=0.999)
    ap.add_argument("--l2_wd", type=float, default=0.0)
    ap.add_argument("--eval_steps", type=int, default=200)
    ap.add_argument("--seed", type=int, default=224)
    ap.add_argument("--save_dir", default="./runs")
    ap.add_argument("--load_path", default=None,
                    help="warm-start params and EMA from another run's ckpts dir (fresh "
                         "step and optimizer); this run's own checkpoints win")
    ap.add_argument("--name", default="mmbidaf")
    ap.add_argument("--max_checkpoints", type=int, default=5)
    ap.add_argument("--metric_name", default="loss")
    ap.add_argument("--max_sentences", type=int, default=32)
    ap.add_argument("--max_words", type=int, default=16)
    ap.add_argument("--data_dir", default=None,
                    help="root of per-video asset dirs; default: the synthetic stream")
    ap.add_argument("--glove_path", default=None, help="GloVe .txt for --data_dir")
    ap.add_argument("--vgg", default="vgg16", choices=["vgg16", "vgg19", "tiny"],
                    help="frontend conv spec (tiny = fast CPU runs)")
    ap.add_argument("--num_seq", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--sp_audio", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--num_model", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--tp_vgg", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--config_json", default=None, help="full Config overlay")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv), {a.dest: a.default for a in ap._actions}


def build_config(a, defaults: dict) -> Config:
    """The config JSON with the flags set to non-default values on top, or
    the defaults with every flag, as ``train.py`` builds it."""
    if a.config_json:
        def over(keys):
            return {k: getattr(a, k) for k in keys if getattr(a, k) != defaults[k]}

        cfg = config_from_json(a.config_json)
        m = over(_MODEL_KEYS)
        if a.no_images:
            m["use_images"] = False
        if a.no_audio:
            m["use_audio"] = False
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, **m),
            data=dataclasses.replace(cfg.data, **over(_DATA_KEYS)),
            train=dataclasses.replace(cfg.train, **over(_TRAIN_KEYS)),
            mesh=dataclasses.replace(cfg.mesh, **over(_MESH_KEYS)))
    cfg = Config()
    model = {k: getattr(a, k) for k in _MODEL_KEYS}
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, **model, use_images=not a.no_images,
                                  use_audio=not a.no_audio),
        data=dataclasses.replace(cfg.data, **{k: getattr(a, k) for k in _DATA_KEYS}),
        mesh=dataclasses.replace(cfg.mesh, **{k: getattr(a, k) for k in _MESH_KEYS}),
        train=dataclasses.replace(cfg.train, **{k: getattr(a, k) for k in _TRAIN_KEYS}))


def split_dirs(data_dir: str) -> tuple[str, str]:
    """``(train_dir, dev_dir)``: ``train/`` and ``dev/`` under the root when
    present (dev falls back to train), else the root for both."""
    train_dir = os.path.join(data_dir, "train")
    if not os.path.isdir(train_dir):
        return data_dir, data_dir
    dev_dir = os.path.join(data_dir, "dev")
    return train_dir, dev_dir if os.path.isdir(dev_dir) else train_dir


def parse_buckets(s: str | None):
    """None → the default ladder; 'off' / 'none' → ``()`` (a static axis)."""
    if s is None:
        return None
    if s.lower() in ("off", "none"):
        return ()
    return tuple(int(b) for b in s.split(","))


def make_stream_factory(a, cfg: Config, corpus, run_dir: str):
    """``stream_factory(skip=0)``: the training batch stream fast-forwarded
    by ``skip`` batches — bucketed, grain or the plain iterator."""
    from mmbidaf_tpu_torch.data import pipeline

    bs, seed = cfg.train.batch_size, cfg.train.seed
    auto_axis = {}
    if a.buckets and a.buckets.lower() == "auto":
        sug = pipeline.suggest_buckets(corpus, num_seq=cfg.mesh.num_seq)
        print("auto buckets: " + ", ".join(f"{k}={list(v)}" for k, v in sug.items()))
        buckets = sug["sentences"]
        auto_axis = {"word": sug["words"], "img": sug["keyframes"], "aud": sug["audio_frames"]}
    else:
        buckets = parse_buckets(a.buckets)
    if buckets:
        def axis(flag, key):
            return parse_buckets(flag) if flag is not None else auto_axis.get(key)

        return lambda skip=0: pipeline.bucketed_iterator(
            corpus, bs, buckets, seed, skip=skip,
            word_buckets=axis(a.word_buckets, "word"), img_buckets=axis(a.img_buckets, "img"),
            aud_buckets=axis(a.aud_buckets, "aud"))
    if a.loader_workers > 0:
        def grain_stream(skip=0):
            it = iter(pipeline.make_grain_loader(corpus, bs, seed, worker_count=a.loader_workers))
            if skip:
                restore_grain_state(it, skip, a.loader_workers, bs, run_dir)
            return it

        return grain_stream
    return lambda skip=0: pipeline.batched_iterator(corpus, bs, seed, skip=skip)


def restore_grain_state(it, step: int, workers: int, batch_size: int, run_dir: str) -> None:
    """Put a grain iterator where the run saved it at ``step``
    (``loader_state.bin`` + ``.step``), translating the state to a new worker
    count when the saved one no longer fits; otherwise the order restarts."""
    from mmbidaf_tpu_torch.data.pipeline import translate_grain_state

    path = os.path.join(run_dir, "loader_state.bin")
    if os.path.exists(path) and os.path.exists(path + ".step"):
        with open(path + ".step") as f:
            saved_step = int(f.read().strip() or 0)
        if saved_step == step:
            with open(path, "rb") as f:
                raw = f.read()
            try:
                it.set_state(raw)
                print(f"grain loader state restored at step {step}")
                return
            except ValueError as e:  # grain refuses another worker count
                try:
                    new_state, repeats = translate_grain_state(raw, workers, batch_size)
                    it.set_state(new_state)
                    print(f"grain loader state translated to worker_count={workers} ({repeats} "
                        "already-seen records will repeat this epoch; none skipped)")
                    return
                except ValueError as e2:
                    print(f"grain loader state unusable ({e}; translation: {e2}); "
                        "data order restarts")
                    return
    print("grain loader: no matching saved loader state — data order restarts on resume")


def featurize_eval_set(corpus, frontend, cfg: Config, vgg_spec, device,
                       max_videos: int) -> list[tuple[dict, list]]:
    """Every dev video (up to ``max_videos``) featurized once, in batches of
    the train batch size whose tails wrap onto the last video: a list of
    ``(feature batch on device, [(sentences, summary)] of the real rows,
    None)`` (``evaluate``'s layout; the synthetic stream's third item holds
    its targets)."""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, cast_vgg_weights
    from mmbidaf_tpu_torch.data.pipeline import collate

    fe = cast_vgg_weights(frontend, cfg.model.compute_dtype)
    bs = cfg.train.batch_size
    n_eval = min(len(corpus), max_videos)
    out = []
    for start in range(0, n_eval, bs):
        idxs = [min(start + j, len(corpus) - 1) for j in range(bs)]
        raw = {k: torch.from_numpy(v).to(device)
               for k, v in collate([corpus[i] for i in idxs]).items()}
        with torch.no_grad():
            feat = apply_frontend(fe, raw, cfg, vgg_spec)
        feat["targets"], feat["target_mask"] = raw["targets"], raw["target_mask"]
        texts = [corpus.example_text(i) for i in idxs[:min(bs, n_eval - start)]]
        out.append((feat, texts, None))
    return out


def main(argv=None) -> None:
    a, defaults = parse_args(argv)
    cfg = build_config(a, defaults)
    mesh = cfg.mesh
    if mesh.sp_audio or mesh.tp_vgg or mesh.num_seq != 1 or mesh.num_model != 1:
        raise NotImplementedError("the mesh layouts (--num_seq, --sp_audio, --num_model, "
                                  "--tp_vgg) are not ported yet (ROADMAP Queue 1)")
    dev = resolve_device(a.device)
    previous = {s: signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _train(a, cfg, dev)
    finally:  # callers that run main in-process keep their own handlers
        for s, handler in previous.items():
            signal.signal(s, handler)


def _train(a, cfg: Config, dev: torch.device) -> None:
    from mmbidaf_tpu_torch.data.synthetic import batch_stream, random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train import checkpoint as ckpt
    from mmbidaf_tpu_torch.train.loop import (init_train_state, make_eval_step,
                                              make_lr_schedule, make_train_step)
    from mmbidaf_tpu_torch.train.metrics import AverageMeter, JsonlLogger, TensorboardWriter

    run_dir = os.path.join(cfg.train.save_dir, cfg.train.name)
    os.makedirs(run_dir, exist_ok=True)
    np_rng = np.random.default_rng(cfg.train.seed)
    frontend = vgg_spec = None
    if a.data_dir:
        from mmbidaf_tpu_torch.data.frontend import frontend_init
        from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
        from mmbidaf_tpu_torch.data.vocab import load_glove, save_vocab, vocab_from_corpus_dir
        from mmbidaf_tpu_torch.ops.vgg import spec_for_variant

        train_dir, dev_dir = split_dirs(a.data_dir)
        w2i = vocab_from_corpus_dir(train_dir, max_size=cfg.data.vocab_size)
        if a.glove_path:
            wv = load_glove(a.glove_path, w2i, cfg.model.emb_dim)
        else:
            wv = random_word_vectors(np_rng, len(w2i), cfg.model.emb_dim)
        vgg_spec = spec_for_variant(a.vgg)
        # the variant and the vocab go with the run: Summarizer.from_run
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, vgg_variant=a.vgg))
        save_vocab(w2i, np.asarray(wv), os.path.join(run_dir, "vocab.json"),
                   os.path.join(run_dir, "emb.npz"))
        corpus = VideoCorpus(train_dir, cfg, w2i, require_summary=True)
        eval_corpus = (corpus if dev_dir == train_dir
                       else VideoCorpus(dev_dir, cfg, w2i, require_summary=True))
        stream_factory = make_stream_factory(a, cfg, corpus, run_dir)
        frontend = frontend_init(cfg, vgg_spec, dev, seed=cfg.train.seed + 2)
    else:
        wv = random_word_vectors(np_rng, cfg.data.vocab_size, cfg.model.emb_dim)
    state = init_train_state(mmbidaf_init(cfg, wv, dev, seed=cfg.train.seed), cfg,
                             seed=cfg.train.seed + 1)
    ckpt.save_config(run_dir, cfg)
    maximize = (cfg.train.maximize_metric if cfg.train.maximize_metric is not None
                else cfg.train.metric_name != "loss")
    manager = ckpt.CheckpointManager(os.path.join(run_dir, "ckpts"), cfg.train.max_checkpoints,
                                     cfg.train.metric_name, maximize)
    restored = manager.restore_latest(state)
    if restored is not None:
        state = restored
        print(f"resumed from step {state.step}")
    elif cfg.train.load_path:
        src_step = ckpt.CheckpointManager(cfg.train.load_path).warm_start(state)
        if src_step is None:
            raise SystemExit(f"no checkpoint found in {cfg.train.load_path}")
        print(f"warm-started params from {cfg.train.load_path} (source step {src_step})")
    train_step = make_train_step(cfg, frontend, vgg_spec)
    eval_step = make_eval_step(cfg)
    schedule = make_lr_schedule(cfg)

    def to_dev(nb):
        return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}

    resumed = state.step
    if a.data_dir:
        # the data order resumes where the run stopped (index-only skipping)
        stream = stream_factory(skip=resumed)
        eval_batches = featurize_eval_set(eval_corpus, frontend, cfg, vgg_spec, dev,
                                          a.max_eval_videos)
    else:
        stream = batch_stream(cfg.train.seed, cfg)
        nb0 = next(stream)
        eval_batches = [(to_dev(nb0), None, nb0["targets"])]
        for _ in range(resumed):  # the stream as far as the resumed run had read it
            next(stream)
    if resumed:
        print(f"data stream fast-forwarded {resumed} batches")
    prefetcher = None
    if a.prefetch > 0:
        from mmbidaf_tpu_torch.data.prefetch import DevicePrefetcher, batch_uploader

        prefetcher = stream = DevicePrefetcher(stream, batch_uploader(dev), depth=a.prefetch)

    if a.num_steps is not None:
        num_steps = a.num_steps
    elif a.data_dir:
        epochs = a.num_epochs or cfg.train.num_epochs
        per_epoch = max(1, len(corpus) // cfg.train.batch_size)
        num_steps = epochs * per_epoch
        print(f"training {epochs} epochs x {per_epoch} steps/epoch = {num_steps} steps")
    else:
        num_steps = 1000

    def save_loader_state():
        # grain's iterator state next to every save: exact data order on
        # resume (the prefetcher reports the last DELIVERED batch's state)
        st = stream.get_state() if hasattr(stream, "get_state") else None
        if st is not None:
            path = os.path.join(run_dir, "loader_state.bin")
            with open(path, "wb") as f:
                f.write(st)
            with open(path + ".step", "w") as f:
                f.write(str(state.step))

    # the padding share of each ragged axis paid each step; word_mask's is
    # taken within real sentences, apart from T_sent's
    pad_axes = {"sent": "sent_mask", "img": "img_mask", "aud": "aud_mask"}
    pad_meters = {k: AverageMeter() for k in (*pad_axes, "word")}

    def update_pad_meters(nb):
        for name, key in pad_axes.items():
            if key in nb:
                pad_meters[name].update(1.0 - float(nb[key].mean()))
        wm, sm = nb["word_mask"], nb["sent_mask"][:, :, None]
        pad_meters["word"].update(1.0 - float((wm * sm).sum()) / max(float(sm.sum()) * wm.shape[2], 1.0))

    logger = JsonlLogger(os.path.join(run_dir, "log.jsonl"))
    tb = TensorboardWriter(os.path.join(run_dir, "tb"))
    preempted = []  # SIGTERM / SIGINT: the loop saves and returns at the next step

    def request_stop(signum, frame):
        preempted.append(signum)

    signal.signal(signal.SIGTERM, request_stop)
    signal.signal(signal.SIGINT, request_stop)
    print(f"training from step {resumed} to step {num_steps}", flush=True)
    last_saved = resumed  # a resumed state is on disk already
    loss_sum, n, t_window = 0.0, 0, time.monotonic()
    try:
        while state.step < num_steps:
            if preempted:
                break
            item = next(stream)
            nb, batch = item if prefetcher is not None else (item, to_dev(item))
            update_pad_meters(nb)
            state, metrics = train_step(state, batch)
            loss_sum, n = loss_sum + metrics["loss"], n + 1
            step = state.step
            if step % LOG_EVERY == 0 or step == num_steps:
                now = time.monotonic()
                scalars = {"loss": float(loss_sum) / n, "grad_norm": float(metrics["grad_norm"]),
                           "lr": schedule(step), "steps_per_s": n / max(now - t_window, 1e-9),
                           "pad_frac": pad_meters["sent"].avg,
                           **{f"pad_frac_{k}": m.avg for k, m in pad_meters.items()
                              if k != "sent" and m.count}}
                logger.log(step, scalars)
                tb.log(step, scalars)
                print(f"step {step}: loss {scalars['loss']:.4f} pad_frac {scalars['pad_frac']:.3f}")
                loss_sum, n, t_window = 0.0, 0, now
                for m in pad_meters.values():
                    m.reset()
            if step % cfg.train.eval_steps == 0:
                scalars = evaluate(eval_step, state.ema_params, eval_batches, cfg)
                logger.log(step, scalars)
                tb.log(step, scalars)
                print(f"step {step}: eval_loss {scalars['eval_loss']:.4f} "
                      f"ROUGE-L {scalars['ROUGE-L']:.3f}")
                manager.save(state, {"loss": scalars["eval_loss"],
                                     **{k: v for k, v in scalars.items() if k != "eval_loss"}})
                save_loader_state()
                last_saved = step
        if preempted:
            manager.save_unranked(state)
            save_loader_state()
            print(f"preempted (signal {preempted[0]}): saved step {state.step}; "
                  "rerun with the same --save_dir to resume")
            return
        if state.step != last_saved:
            # a run that ends between evals still leaves a resume point
            manager.save_unranked(state)
            save_loader_state()
            print(f"saved final state at step {state.step}")
    finally:
        if prefetcher is not None:
            prefetcher.close()
        logger.close()
        tb.close()
    print("done")


def evaluate(eval_step, params, eval_batches, cfg: Config) -> dict:
    """EMA eval over every eval batch: the mean teacher-forced loss and ROUGE
    of the picked sentences (real transcripts against ``summary.txt``, or the
    synthetic stream's placeholder sentences against its targets)."""
    from mmbidaf_tpu_torch.train.metrics import batch_rouge

    evs = [eval_step(params, b) for b, *_ in eval_batches]  # all queued before any read
    loss_sum, n_scored = 0.0, 0
    r_sum = {"ROUGE-1": 0.0, "ROUGE-2": 0.0, "ROUGE-L": 0.0}
    for ev, (_, texts, host_targets) in zip(evs, eval_batches):
        loss_sum += float(ev["loss"])
        picks = ev["picks"].cpu().numpy()
        if texts is not None:
            scores, n_b = batch_rouge(picks, [t[0] for t in texts], [t[1] for t in texts])
        else:
            sentences = [f"transcript sentence {i}." for i in range(cfg.data.max_sentences)]
            golds = [" ".join(sentences[i] for i in row) for row in host_targets]
            scores, n_b = batch_rouge(picks, [sentences] * len(golds), golds)
        for k in r_sum:
            r_sum[k] += scores[k] * n_b
        n_scored += n_b
    return {"eval_loss": loss_sum / max(len(eval_batches), 1),
            **{k: v / max(n_scored, 1) for k, v in r_sum.items()}}


if __name__ == "__main__":
    main()
