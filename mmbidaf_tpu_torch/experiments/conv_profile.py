"""Per-layer VGG-16 conv timing on the card — the port of
``experiments/conv_profile.py``.

Times each VGG-16 conv layer shape at ``--n`` images (default 128), scaled
to ``--scale_to`` (default 512, the bench's frames a batch), in bf16 and in
int8, the 4096³ calibration GEMMs in both, and the whole VGG-16 stack.

- bf16: ``F.conv2d`` (cuDNN on the card), channels-last activations and
  weights. The JAX package runs these convs as XLA convs, not Pallas, so a
  library call is what they port to.
- int8: PyTorch has no int8 convolution on the card, so this arm is the
  layer's im2col product ``[N·H·W, 9·C] · [9·C, K]`` through
  ``torch._int_mm`` with int32 accumulation (the im2col is built once,
  outside the timed call; its K pads to a multiple of 8 with zeros). Its
  JSON line says so in ``form``. The weight, like the int8 calibration
  GEMM's second operand, is held column-major, the layout ``_int_mm`` runs
  fastest on the card; ``gemm_int8_row_major_b`` times the same calibration
  GEMM with a row-major second operand.

Times are medians of synchronised calls (``utils.profiling.timeit``), the
warm-up calls (cuDNN's choice of algorithm, the allocator's first blocks)
untimed.

    python -m mmbidaf_tpu_torch.experiments.conv_profile [--n 128] [--layers all]
    python -m mmbidaf_tpu_torch.experiments.conv_profile --device cpu --n 2 \\
        --layers conv5_x --gemm_size 64 --skip_full              # the CPU

Writes one JSON line per measurement to stdout; ``main`` returns them.
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from mmbidaf_tpu_torch import resolve_device

VGG_LAYERS = [
    # (name, hw, cin, cout)
    ("conv1_1", 224, 3, 64),
    ("conv1_2", 224, 64, 64),
    ("conv2_1", 112, 64, 128),
    ("conv2_2", 112, 128, 128),
    ("conv3_1", 56, 128, 256),
    ("conv3_2", 56, 256, 256),
    ("conv4_1", 28, 256, 512),
    ("conv4_2", 28, 512, 512),
    ("conv5_x", 14, 512, 512),
]
# Times a layer shape occurs in VGG-16 (conv3_2 and conv4_2 stand for two
# convs each, conv5_x for three).
LAYER_REPEATS = {"conv3_2": 2, "conv4_2": 2, "conv5_x": 3}
INT8_FORM = ("im2col [N*H*W, 9C] x [9C, K] (column-major) through torch._int_mm, "
             "int32 accumulation")


def conv_flops(n: int, hw: int, cin: int, cout: int) -> float:
    return 2.0 * n * hw * hw * cin * cout * 9


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()``, each call synchronised on the card."""
    from mmbidaf_tpu_torch.utils.profiling import timeit

    return timeit(fn, iters=iters, warmup=warmup)["p50_s"] * 1e3


def emit(rec: dict, out: list) -> None:
    print(json.dumps(rec), flush=True)
    out.append(rec)


def conv_operands(n: int, hw: int, cin: int, cout: int, device, dtype=torch.bfloat16,
                  seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Normal ``x [N, C, H, W]`` and ``w [K, C, 3, 3]`` (×0.1), channels-last,
    drawn on ``device`` from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, cin, hw, hw, generator=g, device=device).to(dtype)
    w = torch.randn(cout, cin, 3, 3, generator=g, device=device).mul_(0.1).to(dtype)
    return (x.contiguous(memory_format=torch.channels_last),
            w.contiguous(memory_format=torch.channels_last))


def im2col_int8(x: torch.Tensor, k_pad: int = 8) -> torch.Tensor:
    """``x [N, H, W, C]`` int8 → ``[N·H·W, 9·C]`` (padded with zero columns
    to a multiple of ``k_pad``): the 3×3 SAME patches, tap-major (dy, dx)
    then channel, the order of an HWIO weight's rows."""
    n, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)], dim=-1)
    cols = cols.reshape(n * h * w, 9 * c)
    pad = -cols.shape[1] % k_pad
    return F.pad(cols, (0, pad)) if pad else cols


def column_major(m: torch.Tensor) -> torch.Tensor:
    """``m`` with the same values, stored column by column."""
    return m.t().contiguous().t()


def weights_int8(w: torch.Tensor, k_pad: int = 8) -> torch.Tensor:
    """HWIO ``w [3, 3, C, K]`` int8 → ``[9·C (padded), K]`` column-major,
    rows in ``im2col_int8``'s order."""
    wk = w.reshape(-1, w.shape[-1])
    pad = -wk.shape[0] % k_pad
    return column_major(F.pad(wk, (0, 0, 0, pad)) if pad else wk)


def conv_int8_im2col(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """3×3 SAME int8 conv, ``x [N, H, W, C]``, HWIO ``w`` → int32 ``[N, H, W,
    K]``: the im2col product through ``torch._int_mm``."""
    n, h, wd, _ = x.shape
    return torch._int_mm(im2col_int8(x), weights_int8(w)).reshape(n, h, wd, w.shape[-1])


def time_conv_bf16(n, hw, cin, cout, device, iters):
    x, w = conv_operands(n, hw, cin, cout, device)
    ms = time_ms(lambda: F.conv2d(x, w, padding=1), iters)
    return ms, conv_flops(n, hw, cin, cout) / (ms * 1e-3) / 1e12


def time_conv_int8(n, hw, cin, cout, device, iters):
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randint(-127, 127, (n, hw, hw, cin), generator=g, device=device, dtype=torch.int8)
    w = torch.randint(-127, 127, (3, 3, cin, cout), generator=g, device=device, dtype=torch.int8)
    cols, wk = im2col_int8(x), weights_int8(w)
    ms = time_ms(lambda: torch._int_mm(cols, wk), iters)
    del cols
    return ms, conv_flops(n, hw, cin, cout) / (ms * 1e-3) / 1e12


def time_gemm(m, k, n_, dtype, device, iters, b_column_major=True):
    g = torch.Generator(device=device).manual_seed(0)
    if dtype == torch.int8:
        a = torch.randint(-127, 127, (m, k), generator=g, device=device, dtype=torch.int8)
        b = torch.randint(-127, 127, (k, n_), generator=g, device=device, dtype=torch.int8)
        b = column_major(b) if b_column_major else b
        fn = lambda: torch._int_mm(a, b)  # noqa: E731
    else:
        a = torch.randn(m, k, generator=g, device=device).to(dtype)
        b = torch.randn(k, n_, generator=g, device=device).to(dtype)
        fn = lambda: torch.mm(a, b)  # noqa: E731
    ms = time_ms(fn, iters)
    return ms, 2.0 * m * k * n_ / (ms * 1e-3) / 1e12


def time_vgg_full(n, device, iters):
    """The whole VGG-16 forward (convs, pools, fc1, fc2) in bf16 at 224²."""
    from mmbidaf_tpu_torch.ops.vgg import VGG, VGG16_SPEC, vgg_features

    g = torch.Generator(device=device).manual_seed(0)
    params = VGG(VGG16_SPEC, 224, 4096, 3, g, device).to(torch.bfloat16)
    imgs = torch.randn(n, 224, 224, 3, generator=g, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        return time_ms(lambda: vgg_features(params, imgs, VGG16_SPEC), iters)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=128, help="image batch per layer test")
    ap.add_argument("--scale_to", type=int, default=512, help="report times scaled to this batch")
    ap.add_argument("--layers", default="all", help="comma-separated layer names, or all")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a measurement")
    ap.add_argument("--gemm_size", type=int, default=4096, help="M = K = N of the calibration GEMMs")
    ap.add_argument("--skip_int8", action="store_true")
    ap.add_argument("--skip_full", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    names = [x for x, *_ in VGG_LAYERS] if args.layers == "all" else args.layers.split(",")
    unknown = set(names) - {x for x, *_ in VGG_LAYERS}
    if unknown:
        raise SystemExit(f"unknown layers {sorted(unknown)}")
    out: list[dict] = []
    emit({"device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
          "n": args.n}, out)

    g = args.gemm_size
    for dt, tag, col in ((torch.bfloat16, "gemm_bf16", True), (torch.int8, "gemm_int8", True),
                         (torch.int8, "gemm_int8_row_major_b", False)):
        ms, tf = time_gemm(g, g, g, dt, dev, args.iters, b_column_major=col)
        emit({"op": tag, "mnk": g, "ms": ms, "tf_s": tf}, out)

    total_bf16 = 0.0
    for name, hw, cin, cout in VGG_LAYERS:
        if name not in names:
            continue
        mult = LAYER_REPEATS.get(name, 1)
        ms, tf = time_conv_bf16(args.n, hw, cin, cout, dev, args.iters)
        scaled = ms * args.scale_to / args.n * mult
        total_bf16 += scaled
        emit({"op": f"{name}_bf16", "ms_per_call": ms, "tf_s": tf, "x_layers": mult,
              "ms_at_512": scaled}, out)
        if not args.skip_int8:
            ms8, tf8 = time_conv_int8(args.n, hw, cin, cout, dev, args.iters)
            emit({"op": f"{name}_int8", "form": INT8_FORM, "ms_per_call": ms8, "tf_s": tf8,
                  "x_layers": mult, "ms_at_512": ms8 * args.scale_to / args.n * mult}, out)
    emit({"op": "vgg_conv_total_bf16_at_512", "ms": total_bf16, "layers": names}, out)

    if not args.skip_full:
        ms = time_vgg_full(args.n, dev, args.iters)
        emit({"op": "vgg_full_bf16", "ms_per_call": ms,
              "ms_at_512": ms * args.scale_to / args.n}, out)
    return out


if __name__ == "__main__":
    main()
