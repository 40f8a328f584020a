"""Train MMBiDAF with the port on the synthetic corpus — the port of
``train.py``'s default path.

    python -m mmbidaf_tpu_torch.train.cli --num_steps 200 --save_dir runs
    python -m mmbidaf_tpu_torch.train.cli --config_json cfg.json --device cpu

Writes ``<save_dir>/<name>/``: ``config.json``, ``log.jsonl`` (train loss,
grad norm, lr and steps/s every 50 steps; eval loss and ROUGE at every
``eval_steps``), and ``ckpts/`` (ranked by the eval loss at each eval, plus
an unranked save of the final state). A rerun with the same ``--save_dir``
and ``--name`` resumes from the newest checkpoint, the synthetic stream
fast-forwarded to the same batch. The eval runs the EMA parameters on the
stream's first batch; its sentences are placeholder strings, so ROUGE is a
pick-vs-target overlap there, as in ``train.py``.

Not ported yet (raise ``NotImplementedError``): ``--data_dir`` (real
corpora, raw-frame training through the frontend), buckets, the grain
loader, the mesh flags and preemption-signal saves.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.config import Config, config_from_json

_MODEL_KEYS = ("hidden_size", "num_rnn_layers", "drop_prob")
_TRAIN_KEYS = ("batch_size", "lr", "optimizer", "max_grad_norm", "grad_accum_steps",
               "remat_towers", "ema_decay", "l2_wd", "eval_steps", "seed", "save_dir", "name")
_UNPORTED = ("data_dir", "buckets", "word_buckets", "img_buckets", "aud_buckets", "prefetch",
             "loader_workers", "num_seq", "sp_audio", "num_model", "tp_vgg")
LOG_EVERY = 50


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hidden_size", type=int, default=128)
    ap.add_argument("--num_rnn_layers", type=int, default=1)
    ap.add_argument("--drop_prob", type=float, default=0.2)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--num_steps", type=int, default=1000)
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
    ap.add_argument("--name", default="mmbidaf")
    ap.add_argument("--config_json", default=None, help="full Config overlay")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for flag in _UNPORTED:
        ap.add_argument(f"--{flag}", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv), {a.dest: a.default for a in ap._actions}


def build_config(a, defaults: dict) -> Config:
    """The config JSON (or the defaults) with the flags set on the command
    line on top, as ``train.py`` builds it."""
    if a.config_json:
        cfg = config_from_json(a.config_json)
        model = {k: getattr(a, k) for k in _MODEL_KEYS if getattr(a, k) != defaults[k]}
        train = {k: getattr(a, k) for k in _TRAIN_KEYS if getattr(a, k) != defaults[k]}
    else:
        cfg = Config()
        model = {k: getattr(a, k) for k in _MODEL_KEYS}
        train = {k: getattr(a, k) for k in _TRAIN_KEYS}
        train["metric_name"] = "loss"
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model),
                               train=dataclasses.replace(cfg.train, **train))


def main(argv=None) -> None:
    a, defaults = parse_args(argv)
    for flag in _UNPORTED:
        if getattr(a, flag) is not None:
            raise NotImplementedError(f"--{flag} is not ported yet (ROADMAP Queue 1)")
    cfg = build_config(a, defaults)
    dev = resolve_device(a.device)

    from mmbidaf_tpu_torch.data.synthetic import batch_stream, random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train import checkpoint as ckpt
    from mmbidaf_tpu_torch.train.loop import (init_train_state, make_eval_step,
                                              make_lr_schedule, make_train_step)
    from mmbidaf_tpu_torch.train.metrics import JsonlLogger, batch_rouge

    run_dir = os.path.join(cfg.train.save_dir, cfg.train.name)
    os.makedirs(run_dir, exist_ok=True)
    wv = random_word_vectors(np.random.default_rng(cfg.train.seed), cfg.data.vocab_size,
                             cfg.model.emb_dim)
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
    train_step, eval_step = make_train_step(cfg), make_eval_step(cfg)
    schedule = make_lr_schedule(cfg)

    def to_dev(nb):
        return {k: torch.from_numpy(v).to(dev) for k, v in nb.items()}

    stream = batch_stream(cfg.train.seed, cfg)
    eval_np = next(stream)
    eval_batch = to_dev(eval_np)
    for _ in range(state.step):  # the stream as far as the resumed run had read it
        next(stream)
    sentences = [f"transcript sentence {i}." for i in range(cfg.data.max_sentences)]
    golds = [" ".join(sentences[i] for i in row) for row in eval_np["targets"]]

    logger = JsonlLogger(os.path.join(run_dir, "log.jsonl"))
    last_saved = state.step
    loss_sum, n, t_window = 0.0, 0, time.monotonic()
    try:
        while state.step < a.num_steps:
            state, metrics = train_step(state, to_dev(next(stream)))
            loss_sum, n = loss_sum + metrics["loss"], n + 1
            step = state.step
            if step % LOG_EVERY == 0 or step == a.num_steps:
                now = time.monotonic()
                scalars = {"loss": float(loss_sum) / n, "grad_norm": float(metrics["grad_norm"]),
                           "lr": schedule(step), "steps_per_s": n / max(now - t_window, 1e-9)}
                logger.log(step, scalars)
                print(f"step {step}: loss {scalars['loss']:.4f}")
                loss_sum, n, t_window = 0.0, 0, now
            if step % cfg.train.eval_steps == 0:
                ev = eval_step(state.ema_params, eval_batch)
                picks = ev["picks"].cpu().numpy()
                scores, _ = batch_rouge(picks, [sentences] * len(golds), golds)
                scalars = {"eval_loss": float(ev["loss"]), **scores}
                logger.log(step, scalars)
                print(f"step {step}: eval_loss {scalars['eval_loss']:.4f} "
                      f"ROUGE-L {scores['ROUGE-L']:.3f}")
                manager.save(state, {"loss": scalars["eval_loss"], **scores})
                last_saved = step
        if state.step != last_saved:
            manager.save(state)  # unranked: a resume point, not a best-k candidate
            print(f"saved final state at step {state.step}")
    finally:
        logger.close()
    print("done")


if __name__ == "__main__":
    main()
