"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

The sources under ``mmbidaf_tpu_torch/csrc`` compile into one shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), for ``sm_90a`` only: one ``nvcc -c`` per source, all started
together, then one link. The library is built at first use into
``mmbidaf_tpu_torch/_build/`` (git-ignored), under a name keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. ptxas's register / shared-memory report is kept beside
it as ``<name>.log``.

Each C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; pointers and the stream pass as
``c_void_p`` so none is cut to 32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lstm.cu", "lstm_bwd.cu", "bidaf.cu", "bidaf_bwd.cu", "bidaf_tiled.cu",
           "bidaf_tiled_bwd.cu", "mfcc.cu", "winograd.cu", "conv3x3.cu", "preprocess.cu",
           "conv_epilogue.cu")
HEADERS = ("common.cuh", "bidaf_cluster.cuh", "lstm_cluster.cuh", "mma.cuh", "tma.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# Hopper's opt-in shared memory a block (227 KB; csrc/common.cuh::kMaxSmemBytes).
SMEM_LIMIT_BYTES = 232448

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: (argtypes), all return int (a cudaError_t).
SIGNATURES = {
    # gates, mask, w_h, out, h_last, c_last, B, T, H, stream
    "mmb_bilstm_forward": (P, P, P, P, P, P, I, I, I, P),
    # gates, mask, w_h, out, h_last, c_last, h_seq, c_seq, B, T, H, stream
    "mmb_bilstm_forward_train": (P, P, P, P, P, P, P, P, I, I, I, P),
    # gates, mask, w_h, h_seq, c_seq, dout, dh_last, dc_last, dgates,
    # dwh_partial, dw_h, num_splits, B, T, H, route (0: the card's), stream
    "mmb_bilstm_backward": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    # B, H, card -> K6's walk: 1 cluster, 2 grid, 3 l2, 0 none (card 0: by
    # the shape alone; 1: the route mmb_bilstm_backward takes on this card)
    "mmb_lstm_bptt_route": (I, I, I),
    # B, H, card, out[10] -> K6's grid walk plan (card 0: the shape's; 1: the
    # one this card runs): P, CS, NQ, U, UT, Rp, KC, threads, dynamic shared
    # memory a block (bytes), words of device memory
    "mmb_lstm_grid_plan": (I, I, I, P),
    # B, H, P -> clusters of K6's grid walk at P blocks a direction the card
    # holds at once (it needs 2·P/8)
    "mmb_bilstm_backward_grid_occupancy": (I, I, I),
    # B, T -> the length of the dW_h product's N slices
    "mmb_lstm_dwh_split": (I, I),
    # B, H, out[7] -> K1/K5/K6's cluster plan: C, R, U, clusters a direction,
    # blocks, K1/K5's and K6's dynamic shared memory a block
    "mmb_lstm_cluster_plan": (I, I, P),
    # B, H -> clusters of K1's / K5's / K6's walk the card holds at once (<= 0: none)
    "mmb_bilstm_forward_occupancy": (I, I),
    "mmb_bilstm_forward_train_occupancy": (I, I),
    "mmb_bilstm_backward_occupancy": (I, I),
    # B, H -> the L2 routes' rows a block (0: none)
    "mmb_lstm_l2_rows": (I, I),
    # B, H -> blocks of K1's / K5's / K6's walk's L2 route an SM holds (<= 0: none)
    "mmb_bilstm_forward_l2_occupancy": (I, I),
    "mmb_bilstm_forward_train_l2_occupancy": (I, I),
    "mmb_bilstm_backward_l2_occupancy": (I, I),
    # c, q, c_mask, q_mask, w_c, w_q, w_cq, bias, out, B, T_c, T_q, D, stream
    "mmb_bidaf_forward": (P, P, P, P, P, P, P, P, P, I, I, I, I, P),
    # T_c, T_q, D, out[4] -> K2's cluster plan: C, tq, K2's and (at this
    # split) K8's dynamic shared memory a block
    "mmb_bidaf_fused_plan": (I, I, I, P),
    # T_c, T_q, D -> clusters of K2 the card holds at once (<= 0: none)
    "mmb_bidaf_forward_occupancy": (I, I, I),
    # c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, out, B, T_c, T_q, D, stream
    "mmb_bidaf_forward_dropout": (P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P),
    # c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, g, d_c, d_q, d_cd,
    # d_qd, partial, d_params, B, T_c, T_q, D, stream
    "mmb_bidaf_backward": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                           I, I, I, I, P),
    # T_c, T_q, D, out[4] -> K7/K8's cluster plan: C, tq, K7's and K8's
    # dynamic shared memory a block
    "mmb_bidaf_drop_plan": (I, I, I, P),
    # T_c, T_q, D -> clusters of K7 / K8 the card holds at once (<= 0: none)
    "mmb_bidaf_forward_dropout_occupancy": (I, I, I),
    "mmb_bidaf_backward_occupancy": (I, I, I),
    # frames, stride_b, stride_t, cos, sin, mel, dct, logmel, tile_max, out,
    # B, T, win, bins, n_mels, n_mfcc, stream
    "mmb_mfcc_forward": (P, LL, LL, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
    # frames, stride_b, stride_t, window, twiddles (f64), mel_w, mel_range, dct,
    # logmel, tile_max, out, B, T, win, n_fft, n_mels, nnz, n_mfcc, stream
    "mmb_mfcc_fft_forward": (P, LL, LL, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P),
    # frames, stride_b, stride_t, cos, sin, mel, out, B, T, win, bins, n_mels, log, stream
    "mmb_log_mel_forward": (P, LL, LL, P, P, P, P, I, I, I, I, I, I, P),
    # frames, stride_b, stride_t, window, twiddles, mel_w, mel_range, out, B, T, win,
    # n_fft, n_mels, nnz, log, stream
    "mmb_log_mel_fft_forward": (P, LL, LL, P, P, P, P, P, I, I, I, I, I, I, I, P),
    # n_fft, win, ld, n_mels, nnz, f64 -> dynamic shared memory of a block of
    # K4's FFT route (f64 != 0: K3's), in bytes (0: no block fits)
    "mmb_log_mel_fft_smem_bytes": (I, I, I, I, I, I),
    # n_fft, win, ld, n_mels, nnz, f64, out[3] -> the FFT route's block: frames,
    # staged mel weights, dynamic shared memory (bytes)
    "mmb_log_mel_fft_plan": (I, I, I, I, I, I, P),
    # win, bins -> the dense route's frames a block (0: none)
    "mmb_mel_dense_frames": (I, I),
    # c, q, c_mask, q_mask, w_c, w_q, w_cq, bias, out, work, B, T_c, T_q, D, tq_blk, stream
    "mmb_bidaf_tiled_forward": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, P),
    # T_c, T_q, D, tq_blk, out[6] -> K9's plan: C, span, tq, resident, the
    # dynamic shared memory a block, the floats of device memory a block
    "mmb_bidaf_tiled_plan": (I, I, I, I, P),
    # T_c, T_q, D, tq_blk -> clusters of K9 the card holds at once (<= 0: none)
    "mmb_bidaf_tiled_forward_occupancy": (I, I, I, I),
    # c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, out, stats, work,
    # B, T_c, T_q, D, stream (K7's tiled route)
    "mmb_bidaf_tiled_forward_dropout": (P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, P),
    # T_c, T_q, D, out[6] -> K7's tiled plan (as mmb_bidaf_tiled_plan's)
    "mmb_bidaf_tiled_drop_plan": (I, I, I, P),
    # T_c, T_q, D -> clusters of K7's tiled route the card holds at once (<= 0: none)
    "mmb_bidaf_tiled_forward_dropout_occupancy": (I, I, I),
    # c, q, cd, qd, c_mask, q_mask, w_c, w_q, w_cq, bias, g, stats, d_c, d_q,
    # d_cd, d_qd, work, partial, d_params, B, T_c, T_q, D, stream (K8's tiled route)
    "mmb_bidaf_tiled_backward": (P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, P,
                                 I, I, I, I, P),
    # T_c, T_q, D, out[5], out64[1] -> K8's tiled plan: C, tiles a block, tq,
    # the pass and finish blocks' shared memory (bytes); the workspace's
    # floats an example
    "mmb_bidaf_tiled_bwd_plan": (I, I, I, P, P),
    # x, u, bias, out, N, H, W, C, K, relu, bf16, stream
    "mmb_winograd_conv3x3": (P, P, P, P, I, I, I, I, I, I, I, P),
    # x, w, bias, out, N, H, W, Cin, Cout, relu, bf16, schedule, stream
    "mmb_conv3x3": (P, P, P, P, I, I, I, I, I, I, I, I, P),
    # x, w, Cin, Cout -> 1 if K13 in bf16 takes its TMA route for these operands
    "mmb_conv3x3_tma_route": (P, P, I, I),
    # () -> dynamic shared memory of a block of K14's / K11's / K12's / K13's
    # tensor-core body, in bytes
    "mmb_winograd_mma_smem_bytes": (),
    "mmb_conv3x3_mma_smem_bytes": (),
    "mmb_conv3x3_taps_smem_bytes": (),
    "mmb_conv3x3_ring_smem_bytes": (),
    # frames, first_h, wh, first_w, ww, bias, out, N, H, W, S, Th, Tw, rows,
    # band_rows, bf16, stream
    "mmb_preprocess_frames": (P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P),
    # y, bias, out, N, H, W, C, pool, bf16, bias_bf16, stream
    "mmb_conv_epilogue": (P, P, P, I, I, I, I, I, I, I, P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME/bin``, else ``PATH``, else the toolkit's
    default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def compile_command(source: str, out: str | os.PathLike, nvcc: str = "nvcc") -> list[str]:
    """The ``nvcc`` command line that compiles ``csrc/<source>`` to the object ``out``."""
    return [nvcc, *NVCC_FLAGS, "-c", "-o", str(out), str(CSRC / source)]


def link_command(objects, out: str | os.PathLike, nvcc: str = "nvcc") -> list[str]:
    """The ``nvcc`` command line that links the objects into the library ``out``."""
    return [nvcc, "-shared", "-o", str(out), *(str(o) for o in objects)]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmmbidaf_kernels_{source_hash()}.so"


def _run(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands all at once; ``(cmd, returncode, output)`` of each."""
    try:
        procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)) for c in cmds]
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmds[0][0]}): the CUDA kernels cannot be built") from e
    logs = [(c, p.communicate()[0]) for c, p in procs]
    return [(c, p.returncode, log) for (c, log), (_, p) in zip(logs, procs)]


def build() -> Path:
    """Compile the library unless a build of these exact sources exists.
    Raises ``RuntimeError`` with the compiler's output if ``nvcc`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{out.stem}.{os.getpid()}"
    objects = [BUILD_DIR / f"{tag}.{Path(src).stem}.o" for src in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        results = _run([compile_command(s, o, nvcc) for s, o in zip(SOURCES, objects)])
        if all(rc == 0 for _, rc, _ in results):
            results += _run([link_command(objects, tmp, nvcc)])
        out.with_suffix(".log").write_text("".join(f"$ {' '.join(c)}\n{log}" for c, _, log in results))
        for cmd, rc, log in results:
            if rc != 0:
                raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
        for o in objects:
            o.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.mmb_error_string.argtypes = [ctypes.c_int]
            lib.mmb_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def ptxas_resources(log: str) -> dict[str, dict[str, int]]:
    """ptxas's report (``-Xptxas -v``) from a build log, by mangled kernel
    name: ``registers``, ``spill_stores`` and ``spill_loads`` (bytes), and
    ``smem`` (static shared memory, bytes; dynamic shared memory is not in
    it)."""
    out: dict[str, dict[str, int]] = {}
    cur = None
    for line in log.splitlines():
        if m := re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line):
            cur = out.setdefault(m.group(1), {"registers": 0, "spill_stores": 0, "spill_loads": 0,
                                              "smem": 0})
        elif cur is not None and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif cur is not None and (m := re.search(r"Used (\d+) registers", line)):
            cur["registers"] = int(m.group(1))
            if sm := re.search(r"(\d+) bytes smem", line):
                cur["smem"] = int(sm.group(1))
    return out


def check_device(t, name: str) -> None:
    """Raise for a tensor on neither the CPU (the plain version) nor the card
    (the kernel): no kernel or plain version runs there."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")


def check_tensor(t, name: str, shape: tuple, device, dtype=None) -> None:
    """Validate a kernel operand before its pointer goes to C: a contiguous
    tensor of ``dtype`` (f32 when not given) and ``shape`` on ``device``."""
    import torch

    dtype = torch.float32 if dtype is None else dtype
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.mmb_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError {rc} ({msg})")
