"""The frame preprocess alone: the plain two-contraction resize
(``ops/vgg.py::preprocess_frames``) against K10, the banded resize kernel
(``ops/cuda/preprocess_kernel.py``, ``csrc/preprocess.cu``) — the port of
``experiments/preprocess_profile.py``.

At the serving shapes: ``--frames`` (512) uint8 frames of 240x320 resized
to 224², normalised, bf16 out; the median of synchronised calls of each,
then the largest distance between the two in f32 and in bf16 on the first
4 frames.

    python -m mmbidaf_tpu_torch.experiments.preprocess_profile
    python -m mmbidaf_tpu_torch.experiments.preprocess_profile --device cpu --frames 4

One JSON line per arm, then the distances; ``main`` returns them.
"""

from __future__ import annotations

import argparse

import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.conv_profile import emit, time_ms


def main(argv=None) -> list[dict]:
    from mmbidaf_tpu_torch.ops.cuda.preprocess_kernel import preprocess_frames_fused
    from mmbidaf_tpu_torch.ops.vgg import preprocess_frames

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=512)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--size", type=int, default=224)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    dev = resolve_device(a.device)
    out: list[dict] = []
    emit({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          "frames": a.frames, "hw": [a.height, a.width], "size": a.size}, out)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randint(0, 256, (a.frames, a.height, a.width, 3), generator=g, device=dev,
                      dtype=torch.uint8)
    dtype = torch.bfloat16
    for name, fn in (("plain_two_contractions", preprocess_frames),
                     ("k10_fused", preprocess_frames_fused)):
        ms = time_ms(lambda: fn(x, a.size, dtype), a.iters)
        emit({"op": name, "dtype": "bfloat16", "ms_per_batch": ms}, out)
    errs = {}
    for tag, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ref = preprocess_frames(x[:4], a.size, dt).float()
        got = preprocess_frames_fused(x[:4], a.size, dt).float()
        errs[f"max_abs_diff_{tag}"] = (got - ref).abs().max().item()
    emit({"op": "k10_vs_plain", **errs}, out)
    return out


if __name__ == "__main__":
    main()
