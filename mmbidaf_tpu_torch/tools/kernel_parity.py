"""Kernel parity: every hand kernel of the port at serving shapes against its
plain version, on one device.

The port's counterpart of the JAX package's ``tools/kernel_parity.py``, at
that tool's shapes (the bench batch ``--batch``: BiDAF at T_c=32, T_q=512,
D=256; the word BiLSTM at ``batch·32`` rows of 16 steps; 512 audio frames;
``2·batch`` keyframes of 240x320 → 224), plus the VGG-16 conv layers
conv1_2 (224², 64→64), conv3_2 (56², 256→256) and conv5_x (14², 512→512) at
``batch/4`` frames in bf16 for K11-K14. Rows, by kernel: K2 (f32 and bf16),
K7+K8 (the gradients of a trainable block), K9, K1 (output, h, c), K5+K6
(the gradients of a trainable layer), K4, K3, K10 (f32 and bf16), K11, K12,
K13 and K14 at each conv layer.

Each row runs the kernel through its wrapper and the plain version on the
same inputs on the same device and holds them within the tolerance the
wrapper's module states: elementwise ``atol + rtol·|ref|``, or normwise
``atol + rtol·max|ref|`` for gradients. The plain versions compute in full
f32 (K14's rounds V and U to bf16 where the kernel does) with no flag set
here: their products are cuBLAS's, full f32 unless the process turns
``torch.backends.cuda.matmul.allow_tf32`` on (its default is off), and the
one convolution, K11-K13's, pins full f32 itself. On the
CPU every wrapper runs its plain version, so a CPU run checks the shapes
and the plumbing, not a kernel.

    python -m mmbidaf_tpu_torch.tools.kernel_parity [--out F] [--batch 32] [--device cuda]
    python -m mmbidaf_tpu_torch.tools.kernel_parity --device cpu --batch 2   # CPU dry run

Prints one PASS/FAIL line per row, writes the JSON report with ``--out``,
and exits non-zero when a row fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from mmbidaf_tpu_torch import resolve_device
from mmbidaf_tpu_torch.ops import audio
from mmbidaf_tpu_torch.ops.bidaf import BiDAFParams
from mmbidaf_tpu_torch.ops.cuda import (bidaf_kernel, conv_kernel, lstm_kernel, melspec_kernel,
                                        preprocess_kernel, winograd_kernel)
from mmbidaf_tpu_torch.ops.lstm import BiLSTMParams

KERNELS = tuple(f"K{i}" for i in range(1, 15))
# VGG-16 layers for K11-K14: (name, spatial size, C_in, C_out).
CONV_LAYERS = (("conv1_2", 224, 64, 64), ("conv3_2", 56, 256, 256), ("conv5_x", 14, 512, 512))


def ragged_mask(rng, b: int, t: int) -> np.ndarray:
    lengths = rng.integers(1, t + 1, size=b)
    lengths[0] = t
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


def _flat(ts) -> torch.Tensor:
    return torch.cat([t.float().reshape(-1) for t in ts])


def check(rows: list, kernels: tuple, name: str, got: torch.Tensor, ref: torch.Tensor, tol: dict,
          normwise: bool = False) -> dict:
    """Append and print one row: ``got`` within ``tol`` of ``ref``."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = ref.abs().max().item() if ref.numel() else 0.0
    bound = tol["atol"] + tol["rtol"] * (scale if normwise else ref.abs())
    ok = got.shape == ref.shape and bool(torch.isfinite(got).all()) and bool((err <= bound).all())
    row = {"kernels": list(kernels), "name": name, "ok": ok,
           "max_abs_err": err.max().item() if err.numel() else 0.0, "ref_scale": scale,
           "atol": tol["atol"], "rtol": tol["rtol"], "normwise": normwise, "shape": list(got.shape)}
    rows.append(row)
    print(f"{'PASS' if ok else 'FAIL'}  {'+'.join(kernels):6s} {name:44s} max|Δ|={row['max_abs_err']:.3e} "
          f"(atol={tol['atol']:g}, rtol={tol['rtol']:g}{', normwise' if normwise else ''}; "
          f"max|ref|={scale:.3g})", flush=True)
    return row


def _bidaf_rows(rows, rng, dev, gen, B):
    T_c, T_q, D = 32, 512, 256
    p = BiDAFParams(D, gen, dev)
    c = torch.from_numpy(rng.standard_normal((B, T_c, D)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((B, T_q, D)).astype(np.float32)).to(dev)
    cm = torch.from_numpy(ragged_mask(rng, B, T_c)).to(dev)
    qm = torch.from_numpy(ragged_mask(rng, B, T_q)).to(dev)
    tol = bidaf_kernel.TOLERANCE
    with torch.no_grad():
        ref = bidaf_kernel.bidaf_reference(p, c, q, cm, qm)
        check(rows, ("K2",), f"bidaf_attention_fused (f32, {T_c}x{T_q})",
              bidaf_kernel.bidaf_attention_fused(p, c, q, cm, qm), ref, tol)
        pb = BiDAFParams(D, gen, dev).to(torch.bfloat16)
        cb, qb = c.bfloat16(), q.bfloat16()
        check(rows, ("K2",), "bidaf_attention_fused (bf16)",
              bidaf_kernel.bidaf_attention_fused(pb, cb, qb, cm, qm),
              bidaf_kernel.bidaf_reference(pb, cb, qb, cm, qm), tol)
        check(rows, ("K9",), "bidaf_attention_tiled (f32)",
              bidaf_kernel.bidaf_attention_tiled(p, c, q, cm, qm), ref, tol)

    def grads(fn):
        leaves = [p.w_c, p.w_q, p.w_cq, p.bias]
        for t in leaves:
            t.requires_grad_(True)
        cc, qq = c.clone().requires_grad_(True), q.clone().requires_grad_(True)
        loss = (fn(p, cc, qq, cm, qm) ** 2).sum() / B
        g = torch.autograd.grad(loss, leaves + [cc, qq])
        for t in leaves:
            t.requires_grad_(False)
        return g

    g_got = grads(bidaf_kernel.bidaf_attention_fused_trainable)
    g_ref = grads(bidaf_kernel.bidaf_reference)
    for name, sl in (("params", slice(0, 4)), ("c", slice(4, 5)), ("q", slice(5, 6))):
        check(rows, ("K7", "K8"), f"bidaf_fused_trainable grad[{name}]", _flat(g_got[sl]),
              _flat(g_ref[sl]), bidaf_kernel.BACKWARD_TOLERANCE, normwise=True)


def _lstm_rows(rows, rng, dev, gen, B):
    n, T, Din, H = B * 32, 16, 128, 128
    p = BiLSTMParams(Din, H, gen, dev)
    x = torch.from_numpy((rng.standard_normal((n, T, Din)) * 0.3).astype(np.float32)).to(dev)
    m = torch.from_numpy(ragged_mask(rng, n, T)).to(dev)
    with torch.no_grad():
        out, (h, c) = lstm_kernel.bilstm_cuda(p, x, m)
        r_out, (r_h, r_c) = lstm_kernel.bilstm_reference(p, x, m)
    tol = lstm_kernel.TOLERANCE
    check(rows, ("K1",), f"bilstm_cuda out ({n} rows)", out, r_out, tol)
    check(rows, ("K1",), "bilstm_cuda h_n", h, r_h, tol)
    check(rows, ("K1",), "bilstm_cuda c_n", c, r_c, tol)

    def grads(fn):
        leaves = list(p.parameters())
        for t in leaves:
            t.requires_grad_(True)
        xx = x.clone().requires_grad_(True)
        o, (hh, cc) = fn(p, xx, m)
        loss = (o ** 2).sum() / n + (hh * cc).sum() / n
        g = torch.autograd.grad(loss, leaves + [xx])
        for t in leaves:
            t.requires_grad_(False)
        return g

    check(rows, ("K5", "K6"), "bilstm_cuda_trainable grads",
          _flat(grads(lstm_kernel.bilstm_cuda_trainable)), _flat(grads(lstm_kernel.bilstm_reference)),
          lstm_kernel.BPTT_TOLERANCE, normwise=True)


@torch.no_grad()
def _audio_rows(rows, rng, dev, B):
    win = 400
    consts = audio.make_audio_frontend_consts(16000, 512, win, 64, 40, device=dev)
    frames = torch.from_numpy((rng.standard_normal((B, 512, win)) * 0.1).astype(np.float32)).to(dev)
    check(rows, ("K4",), "log_mel_fused (512 frames)", melspec_kernel.log_mel_fused(frames, consts),
          melspec_kernel.log_mel_reference(frames, consts), melspec_kernel.LOG_MEL_TOLERANCE[True])
    check(rows, ("K3",), "mfcc_fused (one-pass whole example)",
          melspec_kernel.mfcc_fused(frames, consts), melspec_kernel.mfcc_reference(frames, consts),
          melspec_kernel.TOLERANCE)


@torch.no_grad()
def _preprocess_rows(rows, rng, dev, B):
    fr = torch.from_numpy(rng.integers(0, 256, (2 * B, 240, 320, 3)).astype(np.uint8)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        check(rows, ("K10",), f"preprocess_frames_fused (240x320->224, {str(dtype)[6:]})",
              preprocess_kernel.preprocess_frames_fused(fr, 224, dtype),
              preprocess_kernel.preprocess_reference(fr, 224, dtype),
              preprocess_kernel.TOLERANCE[dtype])


def conv_operands(rng, dev, n: int, size: int, c_in: int, c_out: int, dtype=torch.bfloat16):
    """Seeded ``x [n, size, size, c_in]``, He-normal ``w [3, 3, c_in, c_out]``
    and a small bias, in ``dtype``."""
    x = rng.standard_normal((n, size, size, c_in)).astype(np.float32)
    w = (rng.standard_normal((3, 3, c_in, c_out)) * math.sqrt(2.0 / (9 * c_in))).astype(np.float32)
    b = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev, dtype) for a in (x, w, b))


@torch.no_grad()
def _conv_rows(rows, rng, dev, B):
    n = max(1, B // 4)
    for layer, size, c_in, c_out in CONV_LAYERS:
        x, w, b = conv_operands(rng, dev, n, size, c_in, c_out)
        shape = f"{layer} N={n} {size}² {c_in}->{c_out}, bf16"
        ref = conv_kernel.conv3x3_reference(x, w, b)
        tol = conv_kernel.TOLERANCE[x.dtype]
        for k, fn in (("K11", conv_kernel.conv3x3_same), ("K12", conv_kernel.conv3x3_same_acc),
                      ("K13", conv_kernel.conv3x3_same_db)):
            check(rows, (k,), f"{fn.__name__} ({shape})", fn(x, w, b), ref, tol)
        check(rows, ("K14",), f"winograd_conv3x3_fused ({shape})",
              winograd_kernel.winograd_conv3x3_fused(x, w, b, relu=True),
              winograd_kernel.winograd_reference(x, w, b, relu=True),
              winograd_kernel.TOLERANCE[x.dtype])


def run(device, batch: int = 32, seed: int = 0) -> dict:
    """Every row at ``batch`` on ``device`` → the report: ``{"device",
    "batch", "n_rows", "n_fail", "results"}``."""
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"kernel_parity: device={name} batch={batch}", flush=True)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows: list[dict] = []
    _bidaf_rows(rows, rng, dev, gen, batch)
    _lstm_rows(rows, rng, dev, gen, batch)
    _audio_rows(rows, rng, dev, batch)
    _preprocess_rows(rows, rng, dev, batch)
    _conv_rows(rows, rng, dev, batch)
    n_fail = sum(not r["ok"] for r in rows)
    print(f"{len(rows) - n_fail}/{len(rows)} parity checks passed", flush=True)
    return {"device": name, "batch": batch, "n_rows": len(rows), "n_fail": n_fail, "results": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="JSON report path")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args(argv)
    if a.batch < 1:
        ap.error("--batch must be at least 1")
    report = run(a.device, a.batch)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {a.out}", flush=True)
    return 1 if report["n_fail"] else 0


if __name__ == "__main__":
    sys.exit(main())
