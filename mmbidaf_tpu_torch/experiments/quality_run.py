"""Held-out learning-quality run — the port of ``experiments/quality_run.py``:
train the trimodal model on a learnable synthetic corpus and track the dev
set's pick accuracy and ROUGE against the oracle ceiling and the random
floor (docs/QUALITY.md).

The whole corpus goes through the frozen frontend (VGG + MFCC) on the
device once; each training batch is then gathered on the device from
indices drawn by a ``torch.Generator`` there, so a step moves nothing from
the host. The train and eval steps are the production ones
(``train/loop.py``: ``make_train_step``, ``make_eval_step`` on the EMA
parameters), ROUGE is ``train/rouge.py``'s. JAX's index stream cannot be
reproduced, so the port's curve is not the JAX one step for step: its
tests hold thresholds, not curves.

    python -m mmbidaf_tpu_torch.experiments.quality_run --steps 500 \\
        --eval_every 100 --out curve.jsonl                      # the card
    python -m mmbidaf_tpu_torch.experiments.quality_run --tiny --device cpu \\
        --videos 24 --dev 4 --steps 200                         # the CPU

A learnable corpus is generated at ``--data_dir`` where that holds none
(by ``examples/make_synthetic_corpus.py``; default: under the temporary
directory). ``tests/test_torch_convergence.py``
runs the CPU-sized twin; ``chip_smoke.py`` phase 14c the full size.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.examples import make_synthetic_corpus


def featurize_corpus(corpus, cfg, vgg_spec, device, chunk: int = 8,
                     frontend=None) -> dict[str, torch.Tensor]:
    """Every corpus example through the frozen frontend (``frontend``, else
    one drawn from seed 1; its weights in the compute dtype) once → stacked
    feature tensors on ``device``, with the targets."""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, cast_vgg_weights, frontend_init
    from mmbidaf_tpu_torch.data.pipeline import collate

    dev = resolve_device(device)
    fe = frontend if frontend is not None else frontend_init(cfg, vgg_spec, dev, seed=1)
    fe = cast_vgg_weights(fe, cfg.model.compute_dtype)
    chunks = []
    with torch.no_grad():
        for a in range(0, len(corpus), chunk):
            raw = collate([corpus[i] for i in range(a, min(a + chunk, len(corpus)))])
            raw = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in raw.items()}
            targets, target_mask = raw.pop("targets"), raw.pop("target_mask")
            feats = apply_frontend(fe, raw, cfg, vgg_spec)
            feats["targets"], feats["target_mask"] = targets, target_mask
            chunks.append(feats)
    return {k: torch.cat([c[k] for c in chunks]) for k in chunks[0]}


def make_batch_sampler(feats: dict[str, torch.Tensor], batch: int):
    """``sample(feats, generator)`` → a batch of ``batch`` rows drawn with
    replacement, the indices drawn on the generator's device."""
    n = next(iter(feats.values())).shape[0]

    def sample(feats, generator: torch.Generator):
        idx = torch.randint(0, n, (batch,), generator=generator, device=generator.device)
        return {k: v[idx] for k, v in feats.items()}

    return sample


def pick_metrics(picks: np.ndarray, targets: np.ndarray,
                 target_mask: np.ndarray) -> dict[str, float]:
    """Set-overlap pick accuracy: |picks ∩ gold| / |gold| per video, plus the
    exact-set match rate (the summary is an ordered *set* of sentences)."""
    overlaps, exacts = [], []
    for b in range(picks.shape[0]):
        k = int(target_mask[b].sum())
        if k == 0:
            continue
        gold = set(int(t) for t in targets[b][:k])
        got = set(int(p) for p in picks[b])
        overlaps.append(len(gold & got) / len(gold))
        exacts.append(float(gold <= got))
    return {
        "pick_overlap": float(np.mean(overlaps)) if overlaps else 0.0,
        "pick_exact": float(np.mean(exacts)) if exacts else 0.0,
        "n": len(overlaps),
    }


def per_cue_recovery(picks: np.ndarray, cues_list) -> dict[str, float]:
    """Per-cue-class pick recovery on a split-cue corpus: of all key
    sentences whose only cue is class c, the fraction in the model's picks
    (a text-only model has no signal for 'image' / 'audio' keys)."""
    hit: dict[str, int] = {}
    tot: dict[str, int] = {}
    for b, cues in enumerate(cues_list):
        got = set(int(p) for p in picks[b])
        for k, c in cues.items():
            tot[c] = tot.get(c, 0) + 1
            hit[c] = hit.get(c, 0) + (1 if int(k) in got else 0)
    return {f"recovered_{c}": round(hit[c] / tot[c], 4) for c in sorted(tot)}


def eval_dev(eval_step, params, dev_feats, dev_meta, batch: int):
    """The dev set in chunks of ``batch`` → pick metrics, ROUGE-1/2/L of the
    assembled summaries, per-cue recovery where the corpus has cues, and
    the teacher-forced loss; and the picks."""
    from mmbidaf_tpu_torch.train.metrics import batch_rouge

    n = next(iter(dev_feats.values())).shape[0]
    picks_all, losses = [], []
    for a in range(0, n, batch):
        out = eval_step(params, {k: v[a:a + batch] for k, v in dev_feats.items()})
        picks_all.append(out["picks"].cpu().numpy())
        losses.append(float(out["loss"]))
    picks = np.concatenate(picks_all, axis=0)
    m = pick_metrics(picks, dev_feats["targets"].cpu().numpy(),
                     dev_feats["target_mask"].cpu().numpy())
    scores, _ = batch_rouge(picks, dev_meta["sentences"], dev_meta["golds"])
    m.update({k: round(v, 4) for k, v in scores.items()})
    if dev_meta.get("cues"):
        m.update(per_cue_recovery(picks, dev_meta["cues"]))
    m["eval_loss"] = float(np.mean(losses))
    return m, picks


def load_split(data_dir: str, cfg):
    """The train / dev ``VideoCorpus`` pair and the dev set's sentences,
    gold summaries and (split-cue corpora) cues for ROUGE."""
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus
    from mmbidaf_tpu_torch.data.text import sent_tokenize
    from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir

    train_dir = os.path.join(data_dir, "train")
    dev_dir = os.path.join(data_dir, "dev")
    if not os.path.isdir(train_dir):
        raise FileNotFoundError(f"{data_dir}: expected train/ + dev/ subdirs "
                                "(make_synthetic_corpus.py --split N)")
    w2i = vocab_from_corpus_dir(train_dir, max_size=cfg.data.vocab_size)
    train = VideoCorpus(train_dir, cfg, w2i)
    dev = VideoCorpus(dev_dir, cfg, w2i)
    sentences, golds, cues = [], [], []
    for vid in dev.video_ids:
        vd = os.path.join(dev_dir, vid)
        with open(os.path.join(vd, "transcript.txt")) as f:
            sentences.append(sent_tokenize(f.read())[: cfg.data.max_sentences])
        with open(os.path.join(vd, "summary.txt")) as f:
            golds.append(f.read())
        cpath = os.path.join(vd, "cues.json")
        if os.path.exists(cpath):
            with open(cpath) as f:
                cues.append({int(k): v for k, v in json.load(f)["cues"].items()
                             if int(k) < cfg.data.max_sentences})
    meta = {"sentences": sentences, "golds": golds}
    if len(cues) == len(sentences):  # per-cue metrics need every dev video
        meta["cues"] = cues
    return train, dev, meta


def run_quality(cfg, data_dir: str, steps: int, batch: int, eval_every: int, vgg_spec,
                seed: int = 0, out_path: str | None = None, log=print, device="cuda",
                frontend=None) -> dict:
    """Featurize → train ``steps`` steps, evaluating the EMA parameters on
    the dev set at step 0 (the random floor), every ``eval_every`` steps and
    at the last → the summary dict (final row, floor, oracle ceiling, the
    curve). ``frontend``: the frozen ``Frontend`` on ``device`` (default:
    drawn from seed 1); the model is drawn from ``seed``, its word vectors
    by numpy from ``seed``."""
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.train.loop import init_train_state, make_eval_step, make_train_step
    from mmbidaf_tpu_torch.train.metrics import batch_rouge

    dev = resolve_device(device)
    train, dev_set, dev_meta = load_split(data_dir, cfg)
    t0 = time.perf_counter()
    train_feats = featurize_corpus(train, cfg, vgg_spec, dev, frontend=frontend)
    dev_feats = featurize_corpus(dev_set, cfg, vgg_spec, dev, frontend=frontend)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    featurize_s = time.perf_counter() - t0
    log(f"featurized {len(train)} train + {len(dev_set)} dev videos in {featurize_s:.1f}s")

    wv = random_word_vectors(np.random.default_rng(seed), cfg.data.vocab_size, cfg.model.emb_dim)
    state = init_train_state(mmbidaf_init(cfg, wv, dev, seed=seed), cfg, seed=seed + 1)
    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    sample = make_batch_sampler(train_feats, batch)
    gen = torch.Generator(device=dev).manual_seed(seed + 2)

    # floor: the untrained model at step 0 (measured); ceiling: the gold picks scored
    oracle_scores, _ = batch_rouge(dev_feats["targets"].cpu().numpy(), dev_meta["sentences"],
                                   dev_meta["golds"])
    curve = []
    sink = open(out_path, "w") if out_path else None

    def record(step, m, losses):
        row = {"step": step,
               "train_loss": round(float(np.mean(losses)), 4) if losses else None,
               **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in m.items()}}
        curve.append(row)
        if sink:
            sink.write(json.dumps(row) + "\n")
            sink.flush()
        cue = "".join(f" {k[10:]}={v:.2f}" for k, v in sorted(m.items())
                      if k.startswith("recovered_"))
        log(f"step {step}: train_loss={row['train_loss']} "
            f"pick_overlap={m['pick_overlap']:.3f} ROUGE-L={m['ROUGE-L']:.3f}" + cue)

    m0, _ = eval_dev(eval_step, state.ema_params, dev_feats, dev_meta, batch)
    record(0, m0, [])
    losses = []
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        state, metrics = train_step(state, sample(train_feats, gen))
        losses.append(metrics["loss"])
        if step % eval_every == 0 or step == steps:
            # one device-to-host copy a window
            losses = torch.stack(losses).cpu().double().tolist()
            m, _ = eval_dev(eval_step, state.ema_params, dev_feats, dev_meta, batch)
            record(step, m, losses)
            losses = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0

    final = {
        "towers": ("text" + ("+image" if cfg.model.use_images else "")
                   + ("+audio" if cfg.model.use_audio else "")),
        "final": curve[-1],
        "floor": {k: curve[0][k] for k in
                  ("pick_overlap", "pick_exact", "ROUGE-1", "ROUGE-2", "ROUGE-L")},
        "oracle_ceiling": {k: round(v, 4) for k, v in oracle_scores.items()},
        "curve": curve,
        "steps": steps,
        "batch": batch,
        "train_videos": len(train),
        "dev_videos": len(dev_set),
        "featurize_s": featurize_s,
        "train_s": train_s,
        "steps_per_s": steps / train_s,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if sink:
        sink.write(json.dumps(final) + "\n")
        sink.close()
    return final


def build_config(a):
    """The run's config from ``main``'s flags: ``--tiny`` (CPU-sized, tiny
    VGG) or the full model (VGG-16 at 224², 512 MFCC frames, bf16, the
    three kernel flags on)."""
    import dataclasses

    from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC

    if a.tiny:
        data = DataConfig(max_sentences=a.sentences, max_words=12, max_keyframes=a.frames,
                          max_audio_frames=64, vocab_size=512, image_size=32, n_fft=256,
                          win_length=256, hop_length=128)
        model = ModelConfig(hidden_size=32, img_feat_dim=64, audio_feat_dim=40,
                            max_decode_steps=3, vgg_variant="tiny")
        spec = TINY_SPEC
    else:
        data = DataConfig(max_sentences=a.sentences, max_words=16, max_keyframes=a.frames,
                          max_audio_frames=512, vocab_size=2048, image_size=224)
        model = ModelConfig(hidden_size=a.hidden, img_feat_dim=4096, audio_feat_dim=40,
                            max_decode_steps=3, compute_dtype="bfloat16",
                            use_pallas_attention=True, use_pallas_lstm=True,
                            use_pallas_melspec=True)
        spec = VGG16_SPEC
    model = dataclasses.replace(model, use_images=not a.no_images, use_audio=not a.no_audio)
    return Config(model=model, data=data, train=TrainConfig(batch_size=a.batch, lr=a.lr)), spec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Held-out quality run on a learnable corpus")
    ap.add_argument("--data_dir", default=None,
                    help="train/dev corpus, generated there if missing (default: a temporary one)")
    ap.add_argument("--out", default=None, help="JSONL curve path")
    ap.add_argument("--videos", type=int, default=240)
    ap.add_argument("--dev", type=int, default=32)
    ap.add_argument("--sentences", type=int, default=12)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true", help="CPU-sized config (tiny VGG, small dims)")
    ap.add_argument("--no_images", action="store_true", help="ablate the image tower")
    ap.add_argument("--no_audio", action="store_true", help="ablate the audio tower")
    ap.add_argument("--cue_mode", choices=("all", "split"), default="all",
                    help="generated-corpus cue assignment (split: one cue a key sentence)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    data_dir = a.data_dir or os.path.join(tempfile.gettempdir(), f"mmbidaf_torch_quality_"
                                                                  f"{a.cue_mode}_v{a.videos}d{a.dev}s{a.seed}")
    if not os.path.isdir(os.path.join(data_dir, "train")):
        make_synthetic_corpus.make_corpus(data_dir, videos=a.videos, sentences=a.sentences,
                                   frames=a.frames, seed=a.seed, learnable=True, split=a.dev,
                                   cue_mode=a.cue_mode)
        print(f"generated learnable corpus under {data_dir}", flush=True)
    cfg, spec = build_config(a)
    final = run_quality(cfg, data_dir, a.steps, a.batch, a.eval_every, spec, seed=a.seed,
                        out_path=a.out, device=a.device, log=lambda *x: print(*x, flush=True))
    print(json.dumps({k: v for k, v in final.items() if k != "curve"}), flush=True)
    return final


if __name__ == "__main__":
    main()
