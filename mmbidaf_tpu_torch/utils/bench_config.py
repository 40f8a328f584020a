"""The benchmark's configuration and its raw batch — the port's copies of
``bench.py::build_bench_config`` and ``make_raw_batch_on_device``
(``bench.py`` imports JAX, so the port keeps its own).
``tools/device_profile.py`` runs this program.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.config import Config, DataConfig, ModelConfig


def build_bench_config(quick: bool) -> Config:
    """``quick``: small CPU-friendly shapes (tiny VGG inputs at 64², 64 audio
    frames, f32, plain paths); otherwise the serving configuration (VGG-16
    at 224², hidden 128, T_s=32 x W=16, 16 keyframes, 512 MFCC frames x 40,
    K=4, bf16, the three kernel flags on)."""
    if quick:
        data = DataConfig(
            max_sentences=16, max_words=8, max_keyframes=4, max_audio_frames=64,
            vocab_size=5000, image_size=64, n_fft=256, win_length=200, hop_length=160,
        )
        model = ModelConfig(hidden_size=64, img_feat_dim=512, audio_feat_dim=40,
                            drop_prob=0.0, max_decode_steps=4)
    else:
        data = DataConfig(
            max_sentences=32, max_words=16, max_keyframes=16, max_audio_frames=512,
            vocab_size=20000, image_size=224,
        )
        model = ModelConfig(hidden_size=128, img_feat_dim=4096, audio_feat_dim=40,
                            drop_prob=0.0, max_decode_steps=4,
                            compute_dtype="bfloat16", use_pallas_attention=True,
                            use_pallas_lstm=True, use_pallas_melspec=True)
    return Config(model=model, data=data)


def make_raw_batch_on_device(cfg: Config, B: int, device, frame_hw: tuple[int, int] = (240, 320),
                             seed: int = 7) -> dict[str, torch.Tensor]:
    """A raw batch made on ``device`` from ``seed`` (no host upload): full
    masks, random words, frames and a noise waveform."""
    d = cfg.data
    g = torch.Generator(device=device).manual_seed(seed)
    T_s, W, T_i, T_a = d.max_sentences, d.max_words, d.max_keyframes, d.max_audio_frames
    n_samples = T_a * d.hop_length + d.win_length
    ones = lambda *s: torch.ones(s, device=device)  # noqa: E731
    return {
        "text_ids": torch.randint(2, d.vocab_size, (B, T_s, W), generator=g, device=device,
                                  dtype=torch.int32),
        "word_mask": ones(B, T_s, W),
        "sent_mask": ones(B, T_s),
        "img_mask": ones(B, T_i),
        "aud_mask": ones(B, T_a),
        "frames": torch.randint(0, 256, (B, T_i, *frame_hw, 3), generator=g, device=device,
                                dtype=torch.uint8),
        "waveform": torch.randn(B, n_samples, generator=g, device=device) * 0.1,
    }
