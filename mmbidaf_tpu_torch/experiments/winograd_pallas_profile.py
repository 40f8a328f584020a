"""K14, the Winograd kernel (``ops/cuda/winograd_kernel.py``,
``csrc/winograd.cu``), against cuDNN's direct conv at VGG-16's deep layers
— the port of ``experiments/winograd_pallas_profile.py``.

Both arms compute conv + bias + ReLU in bf16 at ``--n`` images, scaled to
``--scale_to``: K14 on NHWC activations and HWIO weights, cuDNN through
``F.conv2d`` then ``relu`` on the same storage read as channels-last NCHW.
The JAX script's ``--kblk`` (a Pallas block size) has no counterpart: K14's
tile is fixed (32 output tiles x 64 output channels a block). Each layer's
line also gives the largest distance between the two arms' outputs (two
bf16 roundings of two f32 sums in different orders and transforms).

    python -m mmbidaf_tpu_torch.experiments.winograd_pallas_profile [--n 128]
    python -m mmbidaf_tpu_torch.experiments.winograd_pallas_profile --device cpu --n 1 \\
        --layers conv5_x                      # K14's plain version on the CPU

One JSON line per measurement; ``main`` returns them.
"""

from __future__ import annotations

import argparse

import torch
import torch.nn.functional as F

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.experiments.conv_profile import conv_flops, conv_operands, emit, time_ms

LAYERS = [
    ("conv3_1", 56, 128, 256),
    ("conv3_2", 56, 256, 256),
    ("conv4_1", 28, 256, 512),
    ("conv4_2", 28, 512, 512),
    ("conv5_x", 14, 512, 512),
]


def main(argv=None) -> list[dict]:
    from mmbidaf_tpu_torch.ops.cuda.winograd_kernel import winograd_conv3x3_fused

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
        g = torch.Generator(device=dev).manual_seed(1)
        b = torch.randn(cout, generator=g, device=dev)
        b16 = b.to(torch.bfloat16)
        useful = conv_flops(args.n, hw, cin, cout)

        def direct():
            return F.relu(F.conv2d(x, w, b16, padding=1))

        ms = time_ms(direct, args.iters)
        emit({"op": f"{name}_cudnn", "ms_per_call": ms, "tf_s": useful / (ms * 1e-3) / 1e12,
              "ms_at_512": ms * scale}, out)
        x_nhwc = x.permute(0, 2, 3, 1)  # channels-last storage: contiguous NHWC
        w_hwio = w.permute(2, 3, 1, 0)

        def k14():
            return winograd_conv3x3_fused(x_nhwc, w_hwio, b, relu=True)

        ms = time_ms(k14, args.iters)
        err = (k14().float() - direct().permute(0, 2, 3, 1).float()).abs().max().item()
        emit({"op": f"{name}_k14", "ms_per_call": ms, "tf_s_useful": useful / (ms * 1e-3) / 1e12,
              "ms_at_512": ms * scale, "max_abs_vs_cudnn": err}, out)
        del x, w, x_nhwc, w_hwio
    return out


if __name__ == "__main__":
    main()
