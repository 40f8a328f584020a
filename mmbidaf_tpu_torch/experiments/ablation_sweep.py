"""Per-modality tower ablation — the port of ``experiments/ablation_sweep.py``:
do the image and audio towers move held-out quality?

Trains four configs (text-only, text+image, text+audio, trimodal) on one
split-cue corpus (``examples/make_synthetic_corpus.py`` with ``cue_mode=
"split"``: each key sentence is identifiable by exactly one cue class, so a
text-only model has a ceiling below 1.0 by construction) through
``quality_run.run_quality`` and writes the per-cue-class held-out pick
recovery of each as JSON. Expected: text-only recovers text-cued keys and
is blind to image- and audio-cued ones; each tower adds its own class.

    python -m mmbidaf_tpu_torch.experiments.ablation_sweep --steps 2000 \\
        --out ablation.json                                        # the card
    python -m mmbidaf_tpu_torch.experiments.ablation_sweep --tiny --device cpu \\
        --steps 500 --videos 60 --dev 12 --out /tmp/ablation.json  # the CPU

``tests/test_torch_ablation.py`` runs the CPU-sized twin.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

TOWER_CONFIGS = {
    "text": dict(use_images=False, use_audio=False),
    "text+image": dict(use_images=True, use_audio=False),
    "text+audio": dict(use_images=False, use_audio=True),
    "trimodal": dict(use_images=True, use_audio=True),
}
TABLE_KEYS = ("pick_overlap", "pick_exact", "ROUGE-L", "recovered_text", "recovered_image",
              "recovered_audio")


def build_cfg(a):
    """The sweep's config and VGG spec. Audio features are log-mel: raw MFCC
    c0 reaches ~600 and saturates the audio BiLSTM's gates (the JAX
    package's probe runs learned the audio cue only after the switch)."""
    from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC

    if a.tiny:
        data = DataConfig(max_sentences=a.sentences, max_words=12, max_keyframes=a.frames,
                          max_audio_frames=32, vocab_size=512, image_size=32, n_fft=256,
                          win_length=256, hop_length=128, audio_features="logmel")
        model = ModelConfig(hidden_size=24, img_feat_dim=48, audio_feat_dim=64,
                            max_decode_steps=3, vgg_variant="tiny")
        spec = TINY_SPEC
    else:
        data = DataConfig(max_sentences=a.sentences, max_words=16, max_keyframes=a.frames,
                          max_audio_frames=512, vocab_size=2048, image_size=224,
                          audio_features="logmel")
        model = ModelConfig(hidden_size=a.hidden, img_feat_dim=4096, audio_feat_dim=64,
                            max_decode_steps=3, compute_dtype="bfloat16",
                            use_pallas_attention=True, use_pallas_lstm=True,
                            use_pallas_melspec=True)
        spec = VGG16_SPEC
    return Config(model=model, data=data, train=TrainConfig(batch_size=a.batch, lr=a.lr)), spec


def make_split_corpus(a) -> str:
    """The split-cue corpus of ``a``'s flags at ``a.data_dir`` (default:
    under the temporary directory), written unless there; its audio lasts
    exactly the featurized window (a longer track's tail sentences would
    lose their audio cues to the loader's crop)."""
    from mmbidaf_tpu_torch.examples import make_synthetic_corpus
    from mmbidaf_tpu_torch.serving import num_audio_samples

    cfg0, _ = build_cfg(a)
    seconds = num_audio_samples(cfg0) / cfg0.data.sample_rate
    data_dir = a.data_dir or os.path.join(tempfile.gettempdir(), f"mmbidaf_torch_ablation_v"
                                                                  f"{a.videos}d{a.dev}s{a.seed}"
                                                                  + ("_tiny" if a.tiny else ""))
    if not os.path.isdir(os.path.join(data_dir, "train")):
        make_synthetic_corpus.make_corpus(data_dir, videos=a.videos, sentences=a.sentences,
                                   frames=a.frames, seconds=seconds, seed=a.seed, n_key=a.keys,
                                   learnable=True, split=a.dev, cue_mode="split")
        print(f"generated split-cue corpus under {data_dir} ({seconds:.2f}s audio)", flush=True)
    return data_dir


def run_sweep(a, data_dir: str, log=print) -> dict:
    """Every tower config of ``a.towers`` on ``data_dir`` → the summary
    (corpus, steps, the per-config table and each run's summary)."""
    from mmbidaf_tpu_torch.experiments.quality_run import run_quality

    results = {}
    for name in a.towers.split(","):
        cfg, spec = build_cfg(a)
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **TOWER_CONFIGS[name]))
        log(f"=== {name}")
        curve = os.path.join(a.curves, f"ablation_{name.replace('+', '-')}.jsonl") if a.curves else None
        results[name] = run_quality(cfg, data_dir, a.steps, a.batch, a.eval_every, spec,
                                    seed=a.seed, out_path=curve, log=log, device=a.device)
        log(json.dumps({name: results[name]["final"]}))
    return {
        "corpus": {"videos": a.videos, "dev": a.dev, "sentences": a.sentences,
                   "frames": a.frames, "keys": a.keys, "cue_mode": "split", "seed": a.seed},
        "steps": a.steps, "batch": a.batch, "tiny": a.tiny,
        "table": {name: {k: r["final"].get(k) for k in TABLE_KEYS} for name, r in results.items()},
        "runs": results,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Per-modality tower ablation on a split-cue corpus")
    ap.add_argument("--data_dir", default=None,
                    help="split-cue train/dev corpus, generated there if missing (default: a temporary one)")
    ap.add_argument("--out", default=None, help="summary JSON path (default: printed only)")
    ap.add_argument("--curves", default=None, help="directory for each config's JSONL curve")
    ap.add_argument("--towers", default=",".join(TOWER_CONFIGS),
                    help="comma list from text,text+image,text+audio,trimodal")
    ap.add_argument("--videos", type=int, default=240)
    ap.add_argument("--dev", type=int, default=32)
    ap.add_argument("--sentences", type=int, default=12)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--keys", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--eval_every", type=int, default=250)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    a = parser().parse_args(argv)
    data_dir = make_split_corpus(a)
    summary = run_sweep(a, data_dir, log=lambda *x: print(*x, flush=True))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {a.out}")
    print(json.dumps(summary["table"], indent=1))
    return summary


if __name__ == "__main__":
    main()
