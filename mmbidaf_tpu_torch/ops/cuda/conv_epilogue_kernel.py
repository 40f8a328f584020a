"""The VGG convs' epilogue (``csrc/conv_epilogue.cu``) and its plain version.

Each direct conv of the VGG stack runs as cuDNN's GEMM without a bias
(``F.conv2d(x, w, None, padding=1)``, channels-last); this pass then adds
the bias and applies the ReLU in place, or, after a block's last conv,
reads the conv's output once and writes the 2x2 max pool of
``relu(y + b)`` (floor sizes, as ``F.max_pool2d``). ``y`` is the conv's
``[N, C, H, W]`` output in channels-last storage (f32 or bf16), ``b [C]``.
The JAX package's direct convs are XLA convs, whose epilogue XLA fuses, so
no Pallas kernel stands behind this one.

The plain version (:func:`conv_epilogue_reference`) is what the stack ran
before: the bias added in place (``add_``, which sums in f32 and rounds
once to ``y``'s dtype, as PyTorch adds a conv's bias after cuDNN), the
ReLU, then ``F.max_pool2d``. The kernel makes the same roundings and
comparisons, so given the same conv output it equals the plain version
bit for bit, on the card as on the CPU.

``conv_epilogue`` is the wrapper: on a CPU tensor it runs the plain
version, on a CUDA tensor it launches the kernel or raises;
``conv_epilogue.launches`` counts launches. It calls the custom op
``torch.ops.mmbidaf.conv_epilogue(y, b, pool)`` (CPU: the plain version;
CUDA: the launch, which alone moves the counter; fake: the output's shape),
so ``torch.export`` keeps each epilogue as one node. The op mutates ``y``
(in place without ``pool``) and returns the pooled activation, or an empty
tensor without ``pool``: a custom op may neither return an alias of its
input nor return nothing on one path and a tensor on another. It has no
autograd formula: the VGG is frozen and runs under ``no_grad`` or
``inference_mode`` wherever it runs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mmbidaf_tpu_torch.ops.cuda import build

DTYPES = (torch.float32, torch.bfloat16)


def bias_relu_(y: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``y <- relu(y + b)`` in place, the sum rounded once to ``y``'s dtype;
    returns ``y``."""
    return y.add_(b.view(-1, 1, 1)).relu_()


def conv_epilogue_reference(y: torch.Tensor, b: torch.Tensor, pool: bool) -> torch.Tensor:
    """Plain version: ``relu(y + b)`` rounded once to ``y``'s dtype, then
    the 2x2 max pool if ``pool``; ``y`` is left as it is."""
    z = bias_relu_(y.clone(), b)
    return F.max_pool2d(z, 2, 2) if pool else z


def _layout(y: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last if y.is_contiguous(memory_format=torch.channels_last)
            and not y.is_contiguous() else torch.contiguous_format)


def conv_epilogue(y: torch.Tensor, b: torch.Tensor, pool: bool = False) -> torch.Tensor:
    """A conv's output ``y [N, C, H, W]`` → ``relu(y + b)`` (``y`` itself,
    updated in place), or with ``pool`` its 2x2 max pool ``[N, C, H/2, W/2]``
    (``y`` unchanged), through the custom op
    ``torch.ops.mmbidaf.conv_epilogue``; on the card ``y`` must be
    channels-last. ``conv_epilogue.launches`` moves only where the kernel
    launches."""
    build.check_device(y, "conv_epilogue")
    out = torch.ops.mmbidaf.conv_epilogue(y, b, pool)
    return out if pool else y


conv_epilogue.launches = 0


@torch.library.custom_op("mmbidaf::conv_epilogue", mutates_args=("y",), device_types="cpu")
def conv_epilogue_op(y: torch.Tensor, b: torch.Tensor, pool: bool) -> torch.Tensor:
    """The epilogue as a custom op (the wrapper's contract). On the CPU, the
    plain version."""
    if pool:
        return conv_epilogue_reference(y, b, True).contiguous(memory_format=_layout(y))
    bias_relu_(y, b)
    return y.new_empty(0)


@conv_epilogue_op.register_kernel("cuda")
def _conv_epilogue_launch(y, b, pool):
    if y.dtype not in DTYPES or b.dtype not in DTYPES:
        raise ValueError(f"conv_epilogue: y and b must be f32 or bf16, got {y.dtype} and {b.dtype}")
    N, C, H, W = y.shape
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"conv_epilogue: y must be channels-last on the card, got strides "
                         f"{tuple(y.stride())} for shape {tuple(y.shape)}")
    if pool and (H < 2 or W < 2):
        raise ValueError(f"conv_epilogue: a 2x2 pool needs H, W >= 2, got {H}x{W}")
    build.check_tensor(b, "b", (C,), y.device, b.dtype)
    out = (torch.empty((N, C, H // 2, W // 2), device=y.device, dtype=y.dtype,
                       memory_format=torch.channels_last) if pool else y.new_empty(0))
    lib = build.library()
    rc = lib.mmb_conv_epilogue(
        y.data_ptr(), b.data_ptr(), out.data_ptr() if pool else None, N, H, W, C, int(pool),
        int(y.dtype == torch.bfloat16), int(b.dtype == torch.bfloat16),
        torch.cuda.current_stream(y.device).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_conv_epilogue")
    conv_epilogue.launches += 1
    return out


@conv_epilogue_op.register_fake
def _conv_epilogue_fake(y, b, pool):
    if not pool:
        return y.new_empty(0)
    N, C, H, W = y.shape
    return torch.empty((N, C, H // 2, W // 2), device=y.device, dtype=y.dtype,
                       memory_format=_layout(y))
