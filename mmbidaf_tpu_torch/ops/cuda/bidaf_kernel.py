"""K2: the fused BiDAF attention kernel (``csrc/bidaf.cu``) and its plain version.

Port of ``mmbidaf_tpu/ops/pallas/bidaf_kernel.py::bidaf_attention_fused``
(inference path, no dropout). Inputs are cast to f32 as on the TPU
(``bidaf_kernel.py:117-125``); the output is f32 ``[B, T_c, 4D]``.

``bidaf_attention_fused`` is the wrapper: on a CPU tensor it runs
:func:`bidaf_reference`, on a CUDA tensor it launches the kernel or raises —
also for shapes whose resident S does not fit a block's shared memory.
Tolerance of kernel vs plain on the card: the kernel forms Q2C as
``(s_row·s_colᵀ)·c`` where the plain version contracts ``s_row, s_col, c``
in einsum's order, and sums every product in its own order. On outputs up
to ~12 in magnitude (unit-normal c and q, D=256) the largest error measured
on an H100 was 5.2e-6, so ``atol = 5e-5, rtol = 1e-5``.
"""

from __future__ import annotations

import types

import torch

from mmbidaf_tpu_torch.ops.bidaf import bidaf_apply
from mmbidaf_tpu_torch.ops.cuda import build

TOLERANCE = {"atol": 5e-5, "rtol": 1e-5}

# Shared-memory layout of csrc/bidaf.cu (kTQ q rows per streamed tile).
_TQ = 32
SMEM_LIMIT_BYTES = 232448  # Hopper's opt-in limit per block (227 KB)


def bidaf_smem_bytes(T_c: int, T_q: int, D: int) -> int:
    """Bytes of shared memory the kernel needs: c, a q tile (rows padded by
    one), S and s_col (rows padded by one), P, and three small vectors."""
    return 4 * (T_c * D + _TQ * (D + 1) + 2 * T_c * (T_q + 1) + T_c * T_c + T_c + _TQ + D)


def _f32_params(params) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{k: getattr(params, k).float()
                                    for k in ("w_c", "w_q", "w_cq", "bias")})


def bidaf_reference(params, c, q, c_mask, q_mask) -> torch.Tensor:
    """Plain PyTorch version: ``ops.bidaf.bidaf_apply`` on f32-cast inputs."""
    return bidaf_apply(_f32_params(params), c.float(), q.float(), c_mask.float(), q_mask.float())


def bidaf_attention_fused(params, c, q, c_mask, q_mask) -> torch.Tensor:
    """The whole BiDAF block through the hand kernel → f32 ``[B, T_c, 4D]``.
    ``bidaf_attention_fused.launches`` counts kernel launches."""
    if c.device.type == "cpu":
        return bidaf_reference(params, c, q, c_mask, q_mask)
    if c.device.type != "cuda":
        raise ValueError(f"bidaf_attention_fused: unsupported device {c.device}")
    B, T_c, D = c.shape
    T_q = q.shape[1]
    need = bidaf_smem_bytes(T_c, T_q, D)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"bidaf_attention_fused: T_c={T_c}, T_q={T_q}, D={D} needs {need} bytes of "
            f"shared memory, over the {SMEM_LIMIT_BYTES} a block has"
        )
    dev = c.device
    p = _f32_params(params)
    args = {
        "c": (c.float().contiguous(), (B, T_c, D)),
        "q": (q.float().contiguous(), (B, T_q, D)),
        "c_mask": (c_mask.float().contiguous(), (B, T_c)),
        "q_mask": (q_mask.float().contiguous(), (B, T_q)),
        "w_c": (p.w_c.contiguous(), (D,)),
        "w_q": (p.w_q.contiguous(), (D,)),
        "w_cq": (p.w_cq.contiguous(), (D,)),
        "bias": (p.bias.reshape(1).contiguous(), (1,)),
    }
    for name, (t, shape) in args.items():
        build.check_tensor(t, name, shape, dev)
    out = torch.empty(B, T_c, 4 * D, device=dev)
    lib = build.library()
    rc = lib.mmb_bidaf_forward(
        *(t.data_ptr() for t, _ in args.values()), out.data_ptr(),
        B, T_c, T_q, D, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bidaf_forward")
    bidaf_attention_fused.launches += 1
    return out


bidaf_attention_fused.launches = 0
