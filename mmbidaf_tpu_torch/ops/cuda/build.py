"""Build the CUDA kernels with ``nvcc`` and load them with ``ctypes``.

All sources under ``mmbidaf_tpu_torch/csrc`` compile in one ``nvcc`` call
into one shared library with a plain C interface (no PyTorch headers, so a
build takes seconds), for ``sm_90a`` only. The library is built at first
use into ``mmbidaf_tpu_torch/_build/`` (git-ignored), under a name keyed by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. ptxas's register / shared-memory report
is kept beside it as ``<name>.log``.

Each C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; pointers and the stream pass as
``c_void_p`` so none is cut to 32 bits.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lstm.cu", "bidaf.cu", "mfcc.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: (argtypes), all return int (a cudaError_t).
SIGNATURES = {
    # gates, mask, w_h, out, h_last, c_last, B, T, H, stream
    "mmb_bilstm_forward": (P, P, P, P, P, P, I, I, I, P),
    # c, q, c_mask, q_mask, w_c, w_q, w_cq, bias, out, B, T_c, T_q, D, stream
    "mmb_bidaf_forward": (P, P, P, P, P, P, P, P, P, I, I, I, I, P),
    # frames, stride_b, stride_t, cos, sin, mel, dct, logmel, tile_max, out,
    # B, T, win, bins, n_mels, n_mfcc, stream
    "mmb_mfcc_forward": (P, LL, LL, P, P, P, P, P, P, P, I, I, I, I, I, I, P),
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


def nvcc_command(out: str | os.PathLike, nvcc: str = "nvcc") -> list[str]:
    """The one ``nvcc`` command line that builds the library at ``out``."""
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *(str(CSRC / s) for s in SOURCES)]


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmmbidaf_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile the library unless a build of these exact sources exists.
    Raises ``RuntimeError`` with the compiler's output if ``nvcc`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = nvcc_command(tmp, nvcc_path())
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"nvcc not found ({cmd[0]}): the CUDA kernels cannot be built") from e
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
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


def check_tensor(t, name: str, shape: tuple, device) -> None:
    """Validate a kernel operand before its pointer goes to C: a contiguous
    f32 tensor of ``shape`` on ``device``."""
    import torch

    if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous f32 tensor on {device}, got "
                         f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(t.shape)}")


def check_launch(lib: ctypes.CDLL, rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = lib.mmb_error_string(rc).decode()
        raise RuntimeError(f"{name} failed to launch: cudaError {rc} ({msg})")
