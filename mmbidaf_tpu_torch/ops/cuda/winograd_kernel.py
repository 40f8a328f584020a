"""K14: the Winograd F(2x2,3x3) conv kernel (``csrc/winograd.cu``) and its
plain version.

Port of ``mmbidaf_tpu/ops/pallas/winograd_kernel.py::winograd_conv3x3_fused``:
a 3x3 / stride-1 / SAME conv plus bias (and ReLU) by Winograd F(2x2,3x3),
``x [N, H, W, C]`` (f32 or bf16, contiguous NHWC), ``w [3, 3, C, K]`` (HWIO)
→ ``[N, H, W, K]`` in ``x``'s dtype. It computes what
``ops/winograd.py::winograd_conv3x3`` plus bias and ReLU computes, and that
is its plain version (:func:`winograd_reference`). The transformed weights
U = G g Gᵀ are formed by plain tensor code here, per call, as the JAX
function forms them, and rounded to the compute dtype; the kernel forms V,
the 16 products and the output transform. The TPU kernel's C % 128 rule,
its space-to-depth copy and its padding of the tile count are not carried
over: the kernel takes any N, H, W, C and K, masks the image edge, and
writes NHWC once.

In bf16 (the serving path) the 16 transform-point products run on the
tensor cores: a block of 16 warps takes 32 output tiles x 64 output
channels, forms V once per 32-channel chunk on the CUDA cores and stores it
as bf16, and warp w multiplies V[w] by U[w] with ``mma.sync`` (bf16
operands, f32 accumulators), the next chunk's patches and U brought in by
``cp.async`` meanwhile. In f32 (the parity runs) the kernel keeps its first
scalar body of f32 FMAs on the CUDA cores. ``csrc/winograd.cu``'s header
gives the design and what bounds it.

``winograd_conv3x3_fused`` is the wrapper: on a CPU tensor it runs the plain
version, on a CUDA tensor it launches the kernel or raises;
``winograd_conv3x3_fused.launches`` counts launches. It calls the custom op
``torch.ops.mmbidaf.winograd_conv3x3`` (CPU: the plain version; CUDA: the
launch, which alone moves the counter; fake: the output's shape), so
``torch.export`` keeps each conv as one node.

Tolerance of kernel vs plain on the card (``TOLERANCE``, by dtype): both
form V and U with the same f32 operations and the same roundings, so they
differ only in the order of the f32 sums over C (the kernel sums in chunks,
the tensor cores in their own order and with their own rounding of the
partial sums). In f32 that moves an output of VGG-16's layers (sums of up
to 4608 products, values up to ~10) by a few ulps of the partial sums, so
``atol = 2e-4, rtol = 1e-5``. In bf16 both round f32 values that agree that
closely, which can land one bf16 ulp apart: ``rtol = 2⁻⁷`` (an ulp is at
most 2⁻⁷ of the value) plus the f32 term, ``atol = 2e-4``. Measured on an
H100 in bf16 at VGG-16's twelve C_in >= 32 convs on 256 frames: one ulp at
most (3.1e-2 on values up to ~8).
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.winograd import transform_weights, winograd_conv3x3

TOLERANCE = {torch.float32: {"atol": 2e-4, "rtol": 1e-5},
             torch.bfloat16: {"atol": 2e-4, "rtol": 2.0 ** -7}}


def winograd_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                       relu: bool = False) -> torch.Tensor:
    """Plain version of K14: ``ops.winograd.winograd_conv3x3`` then ReLU
    (ReLU commutes with the final rounding)."""
    y = winograd_conv3x3(x, w, b)
    return torch.relu(y) if relu else y


def winograd_conv3x3_fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
                           relu: bool = False) -> torch.Tensor:
    """3x3 SAME conv (+bias, +ReLU) via the Winograd kernel:
    ``x [N, H, W, C]``, ``w [3, 3, C, K]`` → ``[N, H, W, K]``, through the
    custom op ``torch.ops.mmbidaf.winograd_conv3x3`` (one node in an
    exported program); ``winograd_conv3x3_fused.launches`` moves only where
    the kernel launches."""
    build.check_device(x, "winograd_conv3x3_fused")
    return torch.ops.mmbidaf.winograd_conv3x3(x, w, b, relu)


winograd_conv3x3_fused.launches = 0


@torch.library.custom_op("mmbidaf::winograd_conv3x3", mutates_args=(), device_types="cpu")
def winograd_op(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                relu: bool) -> torch.Tensor:
    """K14 as a custom op (the wrapper's contract). On the CPU, the plain
    version."""
    return winograd_reference(x, w, b, relu).contiguous()


@winograd_op.register_kernel("cuda")
def _winograd_launch(x, w, b, relu):
    if x.dtype not in TOLERANCE:
        raise ValueError(f"winograd_conv3x3_fused: x must be f32 or bf16, got {x.dtype}")
    N, H, W, C = x.shape
    K = w.shape[-1]
    if tuple(w.shape) != (3, 3, C, K):
        raise ValueError(f"winograd_conv3x3_fused: w must be [3, 3, {C}, K], got {tuple(w.shape)}")
    dev = x.device
    u = transform_weights(w).to(x.dtype).reshape(16, C, K).contiguous()
    bias = (b.float() if b is not None else torch.zeros(K, device=dev)).contiguous()
    build.check_tensor(x, "x", (N, H, W, C), dev, x.dtype)
    build.check_tensor(u, "u", (16, C, K), dev, x.dtype)
    build.check_tensor(bias, "b", (K,), dev)
    out = torch.empty(N, H, W, K, device=dev, dtype=x.dtype)
    lib = build.library()
    rc = lib.mmb_winograd_conv3x3(
        x.data_ptr(), u.data_ptr(), bias.data_ptr(), out.data_ptr(), N, H, W, C, K, int(relu),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_winograd_conv3x3")
    winograd_conv3x3_fused.launches += 1
    return out


@winograd_op.register_fake
def _winograd_fake(x, w, b, relu):
    N, H, W, _ = x.shape
    return x.new_empty(N, H, W, w.shape[-1])
