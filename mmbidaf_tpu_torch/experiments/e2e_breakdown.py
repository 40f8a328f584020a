"""Where a serving batch's time goes: the whole program, then the frontend
(resize, VGG, audio) and the model with its decode, each alone — the port of
``experiments/e2e_breakdown.py``.

At the bench configuration (``utils/bench_config.py``: VGG-16 at 224², 16
keyframes, 512 MFCC frames, bf16, the kernel flags on) on a raw batch of
``MMB_BENCH_B`` (default 32; or ``--batch``) made on the card:

- ``full_pipeline``: ``make_end_to_end_decode`` (frontend, model, greedy
  decode; K1-K3);
- ``frontend``: ``apply_frontend`` (resize, VGG, MFCC through K3);
- ``resize_normalize``: ``ops/vgg.py::preprocess_frames`` on the batch's
  frames, in the compute dtype, as the frontend runs it;
- ``vgg_only``: ``vgg_features`` on random images already at 224²
  (contiguous NHWC);
- ``vgg_on_resized``: ``vgg_features`` on the resize's own output, as the
  frontend hands it over (contiguous NHWC, the layout the stack runs in),
  the resize done once beforehand: beside ``vgg_only`` it checks that the
  hand-over costs nothing;
- ``audio_frontend``: ``waveform_to_features`` (K3);
- ``model_decode_on_features``: ``mmbidaf_decode`` on random features (K1, K2).

The VGG weights are cast to the compute dtype once, before any timing
(``cast_vgg_weights``). Times are medians of synchronised calls, the
warm-up calls (the kernel library, plans, cuDNN's choices) untimed.

    python -m mmbidaf_tpu_torch.experiments.e2e_breakdown [--batch 32]
    python -m mmbidaf_tpu_torch.experiments.e2e_breakdown --quick --device cpu --batch 2

One JSON line per stage; ``main`` returns them.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.conv_profile import emit, time_ms

STAGES = ("full_pipeline", "frontend", "resize_normalize", "vgg_only", "vgg_on_resized",
          "audio_frontend", "model_decode_on_features")


def stage_inputs(cfg, B: int, device, seed: int = 0) -> dict[str, torch.Tensor]:
    """The stages' own inputs beside the raw batch, drawn on ``device``:
    ``imgs [B·T_i, S, S, 3]`` in the compute dtype for ``vgg_only``, f32
    ``images [B, T_i, img_feat]`` and ``audio [B, T_a, audio_feat]`` for
    ``model_decode_on_features``."""
    from mmbidaf_tpu_torch.models.mmbidaf import torch_dtype

    d, m = cfg.data, cfg.model
    g = torch.Generator(device=device).manual_seed(seed)
    return {
        "imgs": torch.randn(B * d.max_keyframes, d.image_size, d.image_size, 3, generator=g,
                            device=device).to(torch_dtype(m.compute_dtype)),
        "images": torch.randn(B, d.max_keyframes, m.img_feat_dim, generator=g, device=device),
        "audio": torch.randn(B, d.max_audio_frames, m.audio_feat_dim, generator=g, device=device),
    }


def make_stages(cfg, model, fe, raw: dict, inputs: dict, vgg_spec) -> dict:
    """Each stage as a call of no arguments returning its output (``fe``'s
    VGG weights already in the compute dtype)."""
    from mmbidaf_tpu_torch.data.frontend import apply_frontend, make_end_to_end_decode
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_decode, torch_dtype
    from mmbidaf_tpu_torch.ops import audio as audio_ops
    from mmbidaf_tpu_torch.ops.vgg import preprocess_frames, vgg_features

    d, m = cfg.data, cfg.model
    end_to_end = make_end_to_end_decode(cfg, vgg_spec)
    flat = raw["frames"].reshape((-1,) + tuple(raw["frames"].shape[2:]))
    feats = {k: raw[k] for k in ("text_ids", "word_mask", "sent_mask", "img_mask", "aud_mask")}
    feats.update(images=inputs["images"], audio=inputs["audio"])

    @torch.inference_mode()
    def frontend():
        return apply_frontend(fe, raw, cfg, vgg_spec)

    @torch.inference_mode()
    def resize_normalize():
        return preprocess_frames(flat, d.image_size, torch_dtype(m.compute_dtype))

    @torch.inference_mode()
    def vgg_only():
        return vgg_features(fe.vgg, inputs["imgs"], vgg_spec, winograd=m.use_winograd_conv)

    resized = resize_normalize()

    @torch.inference_mode()
    def vgg_on_resized():
        return vgg_features(fe.vgg, resized, vgg_spec, winograd=m.use_winograd_conv)

    @torch.inference_mode()
    def audio_frontend():
        return audio_ops.waveform_to_features(
            raw["waveform"], fe.audio_consts, d.win_length, d.hop_length, d.max_audio_frames,
            feature=d.audio_features, fused=m.use_pallas_melspec, fft=d.audio_fft)

    @torch.inference_mode()
    def model_decode_on_features():
        return mmbidaf_decode(model, feats, cfg)

    return {"full_pipeline": lambda: end_to_end(model, fe, raw), "frontend": frontend,
            "resize_normalize": resize_normalize, "vgg_only": vgg_only,
            "vgg_on_resized": vgg_on_resized, "audio_frontend": audio_frontend,
            "model_decode_on_features": model_decode_on_features}


def main(argv=None) -> list[dict]:
    from mmbidaf_tpu_torch.data.frontend import cast_vgg_weights, frontend_init
    from mmbidaf_tpu_torch.data.synthetic import random_word_vectors
    from mmbidaf_tpu_torch.models.mmbidaf import mmbidaf_init
    from mmbidaf_tpu_torch.ops.vgg import TINY_SPEC, VGG16_SPEC
    from mmbidaf_tpu_torch.utils.bench_config import build_bench_config, make_raw_batch_on_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=int(os.environ.get("MMB_BENCH_B", "32")))
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--quick", action="store_true", help="small shapes, tiny VGG (the CPU)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    cfg = build_bench_config(a.quick)
    spec = TINY_SPEC if a.quick else VGG16_SPEC
    d, m = cfg.data, cfg.model
    wv = random_word_vectors(np.random.default_rng(0), d.vocab_size, m.emb_dim)
    model = mmbidaf_init(cfg, wv, dev, seed=0)
    fe = cast_vgg_weights(frontend_init(cfg, spec, dev, seed=1), m.compute_dtype)
    raw = make_raw_batch_on_device(cfg, a.batch, dev)
    stages = make_stages(cfg, model, fe, raw, stage_inputs(cfg, a.batch, dev), spec)
    out: list[dict] = []
    emit({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          "batch": a.batch, "compute_dtype": m.compute_dtype}, out)
    for name in STAGES:
        emit({"op": name, "ms": time_ms(stages[name], a.iters)}, out)
    return out


if __name__ == "__main__":
    main()
