"""The plain Winograd F(2x2,3x3) against cuDNN's direct conv at VGG layer
shapes — the port of ``experiments/winograd_profile.py``.

The Winograd arm is ``ops/winograd.py::winograd_conv3x3``, the plain
tensor-code form (K14's plain version without bias and ReLU); the direct arm
is ``F.conv2d`` in bf16, channels-last (cuDNN on the card). Both at ``--n``
images in bf16, scaled to ``--scale_to``; ``tf_s_useful`` counts the direct
conv's multiply-adds over the Winograd arm's time.

    python -m mmbidaf_tpu_torch.experiments.winograd_profile [--n 128]
    python -m mmbidaf_tpu_torch.experiments.winograd_profile --device cpu --n 1 --layers conv5_x

One JSON line per measurement; ``main`` returns them.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.conv_profile import conv_flops, conv_operands, emit, time_ms

LAYERS = [
    ("conv1_2", 224, 64, 64),
    ("conv2_2", 112, 128, 128),
    ("conv3_2", 56, 256, 256),
    ("conv4_2", 28, 512, 512),
    ("conv5_x", 14, 512, 512),
]


def main(argv=None) -> list[dict]:
    from mmbidaf_tpu_torch.ops.winograd import winograd_conv3x3

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--scale_to", type=int, default=512)
    ap.add_argument("--layers", default="all", help="comma-separated layer names, or all")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [x for x, *_ in LAYERS] if args.layers == "all" else args.layers.split(",")
    out: list[dict] = []
    emit({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          "n": args.n}, out)
    scale = args.scale_to / args.n
    for name, hw, cin, cout in LAYERS:
        if name not in names:
            continue
        x, w = conv_operands(args.n, hw, cin, cout, dev)
        useful = conv_flops(args.n, hw, cin, cout)
        ms = time_ms(lambda: F.conv2d(x, w, padding=1), args.iters)
        emit({"op": f"{name}_direct", "ms_per_call": ms, "tf_s": useful / (ms * 1e-3) / 1e12,
              "ms_at_512": ms * scale}, out)
        x_nhwc = x.permute(0, 2, 3, 1)  # channels-last storage: NHWC without a copy
        w_hwio = w.permute(2, 3, 1, 0)
        ms = time_ms(lambda: winograd_conv3x3(x_nhwc, w_hwio), args.iters)
        emit({"op": f"{name}_win", "ms_per_call": ms,
              "tf_s_useful": useful / (ms * 1e-3) / 1e12, "ms_at_512": ms * scale}, out)
        del x, w, x_nhwc, w_hwio
    return out


if __name__ == "__main__":
    main()
