"""K11, K12 and K13: the direct 3x3 conv kernels (``csrc/conv3x3.cu``) and
their plain version.

Port of ``mmbidaf_tpu/ops/pallas/conv_kernel.py``: ``conv3x3_same`` (K11, an
im2col patch matrix and one product), ``conv3x3_same_acc`` (K12, nine
accumulated tap products over a haloed input slab) and ``conv3x3_same_db``
(K13, K12 with the next input slab fetched while the current one computes).
The three compute one function — a 3x3 / stride-1 / SAME conv plus bias
plus ReLU, ``x [N, H, W, Cin]`` (f32 or bf16, contiguous NHWC), ``w [3, 3,
Cin, Cout]`` (HWIO), ``b [Cout]`` → ``[N, H, W, Cout]`` in ``x``'s dtype,
with the weights and bias rounded to that dtype and f32 accumulation, for
any Cin and Cout — and differ only in how the TPU moved data.

What bounds them on the H100 is operations (2·9·Cin·Cout a pixel), at the
tensor cores' rate in bf16. Here each is one CUDA implicit GEMM of an 8x16
pixel tile x 64 output channels with ``mma.sync`` (bf16 operands, f32
accumulators): K11 gathers each 16-channel chunk's im2col patch by
``cp.async`` (two stages); K12 loads a 32-channel haloed slab and its
weights by ``cp.async`` (one stage) and reads the slab at nine shifted rows,
so no patch is copied; K13 is K12's products fed by a three-stage ring in a
persistent block, its slab and weights brought by TMA with an ``mbarrier``
a stage where Cin and Cout are multiples of 8 and both operands 16-byte
aligned, and by K12's ``cp.async`` loaders in a two-stage ring elsewhere
(``conv3x3_same_db.route`` names the route of its last bf16 launch). In f32
the three are scalar bodies on the CUDA cores (parity runs only). The
TPU's ``H % tile_h`` and ``W % 8`` rules are not carried over: the block
masks the image edge. ``csrc/conv3x3.cu``'s header gives each design and
what bounds it.

:func:`conv3x3_reference` is the plain version of all three: ``F.conv2d``
in full f32 (TF32 off whatever the process's flag) on the same rounded
operands, plus bias, ReLU, one cast. Each wrapper runs it on a CPU tensor
and launches its kernel on a CUDA tensor, or raises; ``<wrapper>.launches``
counts its launches.

Tolerance of kernel vs plain on the card (``TOLERANCE``, by dtype): the
kernels sum the 9·Cin products of an output in their own order (in bf16 in
the tensor cores' order, with their rounding of the partial sums). At
VGG-16's layer shapes (up to 4608 products, outputs up to ~10) f32 sums in
different orders differ by a few ulps of the partial sums, so ``atol =
1e-4, rtol = 1e-5``; in bf16 both sides round such f32 values to bf16,
which can land one ulp (at most 2⁻⁷ of the value) apart. Measured on an
H100 in bf16 at conv1_2, conv3_2 and conv5_x (8 frames): one ulp at most
(3.1e-2 on values up to 7.9) for every body.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmbidaf_tpu_torch.ops.common import full_f32_convs
from mmbidaf_tpu_torch.ops.cuda import build

TOLERANCE = {torch.float32: {"atol": 1e-4, "rtol": 1e-5},
             torch.bfloat16: {"atol": 1e-4, "rtol": 2.0 ** -7}}

# Schedules of the CUDA source, by wrapper (the ``schedule`` argument of
# ``mmb_conv3x3``).
_SCHEDULE = {"conv3x3_same": 0, "conv3x3_same_acc": 1, "conv3x3_same_db": 2}


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = True) -> torch.Tensor:
    """Plain version of K11-K13: ``F.conv2d`` in full f32 on ``x`` and on the
    weights and bias rounded to ``x``'s dtype, + bias, ReLU, one cast."""
    dtype = x.dtype
    with full_f32_convs(torch.float32):
        y = F.conv2d(x.float().permute(0, 3, 1, 2), w.to(dtype).float().permute(3, 2, 0, 1),
                     b.to(dtype).float(), padding=1).permute(0, 2, 3, 1)
    if relu:
        y = torch.relu(y)
    return y.to(dtype)


def _conv(fn, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool) -> torch.Tensor:
    """Run wrapper ``fn``: its plain version on a CPU tensor, its schedule of
    ``mmb_conv3x3`` on a CUDA tensor (counted in ``fn.launches``)."""
    name = fn.__name__
    if x.device.type == "cpu":
        return conv3x3_reference(x, w, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in TOLERANCE:
        raise ValueError(f"{name}: x must be f32 or bf16, got {x.dtype}")
    N, H, W, Cin = x.shape
    Cout = w.shape[-1]
    if tuple(w.shape) != (3, 3, Cin, Cout):
        raise ValueError(f"{name}: w must be [3, 3, {Cin}, Cout], got {tuple(w.shape)}")
    dev = x.device
    wk = w.to(x.dtype).contiguous()
    bias = b.to(x.dtype).float().contiguous()
    build.check_tensor(x, "x", (N, H, W, Cin), dev, x.dtype)
    build.check_tensor(wk, "w", (3, 3, Cin, Cout), dev, x.dtype)
    build.check_tensor(bias, "b", (Cout,), dev)
    out = torch.empty(N, H, W, Cout, device=dev, dtype=x.dtype)
    lib = build.library()
    bf16 = x.dtype == torch.bfloat16
    rc = lib.mmb_conv3x3(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), N, H, W, Cin, Cout,
        int(relu), int(bf16), _SCHEDULE[name], torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, f"mmb_conv3x3 ({name})")
    if fn is conv3x3_same_db:
        fn.route = ("scalar" if not bf16 else
                    "tma" if lib.mmb_conv3x3_tma_route(x.data_ptr(), wk.data_ptr(), Cin, Cout)
                    else "cp.async")
    fn.launches += 1
    return out


def conv3x3_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """K11: the im2col schedule (a patch matrix per input-channel chunk in
    shared memory, then one product; on the tensor cores in bf16)."""
    return _conv(conv3x3_same, x, w, b, relu)


def conv3x3_same_acc(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """K12: nine tap products accumulated over a haloed input slab."""
    return _conv(conv3x3_same_acc, x, w, b, relu)


def conv3x3_same_db(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """K13: K12's products with the next chunks' slab and weights in flight
    (a three-stage TMA ring, or a two-stage ``cp.async`` one where TMA
    cannot take the operands)."""
    return _conv(conv3x3_same_db, x, w, b, relu)


conv3x3_same.launches = 0
conv3x3_same_acc.launches = 0
conv3x3_same_db.launches = 0
# K13's route at its last launch: "tma" or "cp.async" in bf16, "scalar" in f32.
conv3x3_same_db.route = None
