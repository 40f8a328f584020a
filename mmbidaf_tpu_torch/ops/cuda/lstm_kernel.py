"""K1: the BiLSTM recurrence kernel (``csrc/lstm.cu``) and its plain version.

Port of ``mmbidaf_tpu/ops/pallas/lstm_kernel.py::bilstm_pallas``. As on the
TPU, the input projection ``x @ W_x + b`` is one GEMM outside the kernel
(here for both directions at once), rounded in the operands' dtype and then
cast to f32; the kernel runs the recurrence of both directions in f32 and
writes the ``[B, T, 2h]`` output and the carried ``h``/``c`` directly.

``bilstm_cuda`` is the wrapper: on a CPU tensor it runs
:func:`bilstm_reference`, on a CUDA tensor it launches the kernel or raises.
Tolerance of kernel vs plain on the card: the kernel sums ``h @ W_h`` in
its own order and uses CUDA's ``expf``/``tanhf``, so outputs differ by f32
rounding that the recurrence carries forward. Outputs are below 1 in
magnitude (``|h|, |c|`` stay small by construction); the largest error
measured at the five bench-shape towers (up to 512 steps) on an H100 was
2.4e-7, so ``atol = 1e-5`` leaves a 40x margin and still catches a wrong
gate, step or mask.
"""

from __future__ import annotations

import torch

from mmbidaf_tpu_torch.ops.common import mm
from mmbidaf_tpu_torch.ops.cuda import build
from mmbidaf_tpu_torch.ops.lstm import lstm_cell

TOLERANCE = {"atol": 1e-5, "rtol": 0.0}


def _projection(params, x: torch.Tensor) -> torch.Tensor:
    """Both directions' ``x @ W_x + b`` → f32 ``[B, T, 8h]`` (fwd | bwd),
    computed in the operands' promoted dtype first, as
    ``(x @ w_x + b).astype(f32)`` is in ``lstm_pallas``."""
    w_x = torch.cat([params.fwd.w_x, params.bwd.w_x], dim=1)
    b = torch.cat([params.fwd.b, params.bwd.b])
    return (mm(x, w_x) + b).float()


def lstm_recurrence_reference(gates: torch.Tensor, mask: torch.Tensor, w_h: torch.Tensor,
                              reverse: bool):
    """Plain version of one direction of the kernel: f32 ``gates [B, T, 4h]``,
    ``mask [B, T]``, ``w_h [h, 4h]`` → ``(out [B, T, h], h_last, c_last)``."""
    B, T, _ = gates.shape
    h = gates.new_zeros(B, w_h.shape[0])
    c = torch.zeros_like(h)
    out = gates.new_zeros(B, T, w_h.shape[0])
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h_new, c_new = lstm_cell(gates[:, t], h, c, w_h)
        m = mask[:, t, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        out[:, t] = h_new * m
    return out, h, c


def bilstm_reference(params, x: torch.Tensor, mask: torch.Tensor):
    """Plain PyTorch version of the kernel path: ``(out [B, T, 2h],
    (h_last, c_last) [B, 2h])`` in f32."""
    gates = _projection(params, x)
    m = mask.float()
    H = params.fwd.w_h.shape[0]
    out_f, h_f, c_f = lstm_recurrence_reference(gates[..., :4 * H], m, params.fwd.w_h.float(), False)
    out_b, h_b, c_b = lstm_recurrence_reference(gates[..., 4 * H:], m, params.bwd.w_h.float(), True)
    return torch.cat([out_f, out_b], -1), (torch.cat([h_f, h_b], -1), torch.cat([c_f, c_b], -1))


def bilstm_cuda(params, x: torch.Tensor, mask: torch.Tensor):
    """One BiLSTM layer through the hand kernel (``bilstm_pallas``'s
    contract). ``bilstm_cuda.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return bilstm_reference(params, x, mask)
    if x.device.type != "cuda":
        raise ValueError(f"bilstm_cuda: unsupported device {x.device}")
    B, T, _ = x.shape
    H = params.fwd.w_h.shape[0]
    dev = x.device
    gates = _projection(params, x).contiguous()
    m = mask.float().contiguous()
    w_h = torch.stack([params.fwd.w_h, params.bwd.w_h]).float().contiguous()
    build.check_tensor(gates, "gates", (B, T, 8 * H), dev)
    build.check_tensor(m, "mask", (B, T), dev)
    build.check_tensor(w_h, "w_h", (2, H, 4 * H), dev)
    out = torch.empty(B, T, 2 * H, device=dev)
    h_last = torch.empty(B, 2 * H, device=dev)
    c_last = torch.empty(B, 2 * H, device=dev)
    lib = build.library()
    rc = lib.mmb_bilstm_forward(
        gates.data_ptr(), m.data_ptr(), w_h.data_ptr(), out.data_ptr(),
        h_last.data_ptr(), c_last.data_ptr(), B, T, H,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check_launch(lib, rc, "mmb_bilstm_forward")
    bilstm_cuda.launches += 1
    return out, (h_last, c_last)


bilstm_cuda.launches = 0
