"""Precompute per-video model features (the reference's artifact flow) — the
port's counterpart of the repository's ``tools/precompute_features.py``.

The reference preprocesses each video once — VGG fc features and MFCC
frames saved as artifacts — and trains from those (SURVEY §4.1). The port's
trainer runs the frozen frontend inside every raw-batch step, and the f32
VGG-16 is most of that step; this tool runs the port's ``apply_frontend``
over each split of a corpus once, on the card under ``inference_mode``, and
writes ``features.npz`` beside each video's assets with the JAX package's
keys:

    images   [T_img, img_feat_dim]   (VGG fc2 features)
    audio    [T_aud, n_mfcc]         (MFCC frames)
    img_mask [T_img], aud_mask [T_aud]

``VideoCorpus`` reads ``features.npz`` where present, and the trainer then
takes the feature-batch step. The frontend is seeded from ``seed + 2``, as
``train.cli`` seeds its frontend, so pass the run's ``--seed``:

    python -m mmbidaf_tpu_torch.tools.precompute_features --data_dir corpus \\
        --config_json cfg.json [--vgg vgg16] [--batch 8] [--seed 224] [--force] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def precompute(data_dir: str, cfg, frontend, vgg_spec, batch: int = 8, force: bool = False,
               log=print) -> int:
    """Write ``features.npz`` for every video of ``data_dir`` (each of its
    ``train``/``dev``/``test`` splits where a ``train/`` exists) that lacks
    one (all of them with ``force``), featurized by ``frontend`` on its
    device in batches of ``batch``. Returns the number of videos written."""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, cast_vgg_weights
    from mmbidaf_tpu_torch.data.pipeline import VideoCorpus, collate
    from mmbidaf_tpu_torch.data.vocab import vocab_from_corpus_dir

    frontend = cast_vgg_weights(frontend, cfg.model.compute_dtype)
    device = frontend.audio_consts["cos"].device
    roots = [data_dir]
    if os.path.isdir(os.path.join(data_dir, "train")):
        roots = [os.path.join(data_dir, s) for s in ("train", "dev", "test")
                 if os.path.isdir(os.path.join(data_dir, s))]
    w2i = vocab_from_corpus_dir(roots[0])  # the text is not featurized
    done = 0
    for root in roots:
        corpus = VideoCorpus(root, cfg, w2i, use_precomputed=False)
        todo = [i for i, vid in enumerate(corpus.video_ids)
                if force or not os.path.exists(os.path.join(root, vid, "features.npz"))]
        for start in range(0, len(todo), batch):
            idxs = todo[start:start + batch]
            nb = collate([corpus[i] for i in idxs])
            raw = {k: torch.from_numpy(v).to(device) for k, v in nb.items()}
            with torch.inference_mode():
                feat = apply_frontend(frontend, raw, cfg, vgg_spec)
            images, audio = feat["images"].cpu().numpy(), feat["audio"].cpu().numpy()
            for j, i in enumerate(idxs):
                np.savez(os.path.join(root, corpus.video_ids[i], "features.npz"),
                         images=images[j], audio=audio[j],
                         img_mask=nb["img_mask"][j], aud_mask=nb["aud_mask"][j])
                done += 1
            log(f"{root}: {min(start + batch, len(todo))}/{len(todo)}")
    return done


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write features.npz for every video of a corpus")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--config_json", default=None)
    ap.add_argument("--vgg", default="vgg16", choices=["vgg16", "vgg19", "tiny"])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=224, help="the run's seed (frontend: seed + 2)")
    ap.add_argument("--force", action="store_true", help="overwrite existing")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    from mmbidaf_tpu_torch import resolve_device
    from mmbidaf_tpu_torch.config import Config, config_from_json
    from mmbidaf_tpu_torch.data.frontend import frontend_init
    from mmbidaf_tpu_torch.ops.vgg import spec_for_variant

    cfg = config_from_json(a.config_json) if a.config_json else Config()
    vgg_spec = spec_for_variant(a.vgg)
    fe = frontend_init(cfg, vgg_spec, resolve_device(a.device), seed=a.seed + 2)
    t0 = time.perf_counter()
    done = precompute(a.data_dir, cfg, fe, vgg_spec, a.batch, a.force,
                      log=lambda s: print(s, flush=True))
    print(f"wrote features.npz for {done} videos in {time.perf_counter() - t0:.2f} s")


if __name__ == "__main__":
    main()
