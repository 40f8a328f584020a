"""ctypes bindings for the C++ host-side decode runtime — the port's copy of
``mmbidaf_tpu.native.loader``, built from the port's own
``native/mmbidaf_native.cpp``.

The library is built at first use with ``g++`` (the host compiler ``nvcc``
needs too) into ``mmbidaf_tpu_torch/_build/``, under a name keyed by a hash
of the source and the compiler flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. libpng and libjpeg are probed as the JAX
package's ``native/Makefile`` probes them: header and library compiled and
linked together, the define and the ``-l`` flag kept as one, so the
source's ``#ifdef`` gates always agree with what is linked.

Every entry point keeps the JAX semantics: a format the build lacks, or a
malformed blob, decodes through PIL; where no compiler is found, or the
build fails, everything decodes through PIL. The path taken is visible:
``native_codecs()`` names the formats the build has, a failed build warns
with the compiler's output, and ``decode_counts`` counts the images decoded
natively and through PIL (as the kernels' ``.launches`` counters do).
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).with_name("mmbidaf_native.cpp")
BUILD_DIR = _PKG / "_build"
# No -march=native (the JAX Makefile's): the decode work is libpng's and
# libjpeg's, and a library keyed only on its source must load on any x86 host.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
# (define, link flag, probe program) per codec; jpeglib.h uses FILE, so
# <cstdio> comes first
_CODEC_PROBES = {
    "png": ("-DMMB_HAVE_PNG", "-lpng", "#include <png.h>\nint main(){return 0;}\n"),
    "jpeg": ("-DMMB_HAVE_JPEG", "-ljpeg",
             "#include <cstdio>\n#include <jpeglib.h>\nint main(){return 0;}\n"),
}
_CODEC_BITS = {"png": 1, "jpeg": 2}

_lib = None
_lib_lock = threading.Lock()
_build_failed = False

# images decoded natively / through PIL, over the process
decode_counts = {"native": 0, "pil": 0}
_count_lock = threading.Lock()


def _count(path: str, n: int = 1) -> None:
    with _count_lock:
        decode_counts[path] += n


def _probe(cxx: str, program: str, lib: str) -> bool:
    res = subprocess.run([cxx, "-x", "c++", "-", "-o", os.devnull, lib], input=program,
                         capture_output=True, text=True, timeout=60)
    return res.returncode == 0


def build_flags(cxx: str = "g++") -> list[str]:
    """The flags the library is built with: ``CXX_FLAGS`` plus each codec's
    define and library where its probe compiles and links."""
    flags = list(CXX_FLAGS)
    for define, lib, program in _CODEC_PROBES.values():
        if _probe(cxx, program, lib):
            flags += [define, lib]
    return flags


def library_path(flags) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libmmbidaf_native_{h.hexdigest()[:16]}.so"


def build(cxx: str = "g++") -> Path:
    """Compile the library unless a build of this exact source and these
    flags exists. Raises ``RuntimeError`` with the compiler's output if
    ``g++`` fails."""
    flags = build_flags(cxx)
    out = library_path(flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    # the -l flags after the source, so the linker resolves its symbols
    libs = [f for f in flags if f.startswith("-l")]
    cmd = [cxx, *(f for f in flags if f not in libs), "-o", str(tmp), str(SOURCE),
           "-lpthread", *libs]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}): {' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    c_long, c_int, c_char_p = ctypes.c_long, ctypes.c_int, ctypes.c_char_p
    p_long, p_u8, p_f32 = (ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_uint8),
                           ctypes.POINTER(ctypes.c_float))
    sigs = {
        "mmb_wav_decode": (c_long, [c_char_p, c_long, p_f32, c_long, ctypes.POINTER(c_int)]),
        "mmb_ppm_header": (c_int, [c_char_p, c_long, p_long, p_long]),
        "mmb_ppm_decode": (c_int, [c_char_p, c_long, p_u8, c_long]),
        "mmb_image_header": (c_int, [c_char_p, c_long, p_long, p_long]),
        "mmb_image_decode": (c_long, [c_char_p, c_long, p_u8, c_long]),
        "mmb_image_decode_batch": (None, [ctypes.POINTER(c_char_p), p_long, c_long,
                                          ctypes.POINTER(p_u8), p_long, p_long, c_int]),
        "mmb_pad_waveforms": (None, [ctypes.POINTER(p_f32), p_long, c_long, c_long, p_f32,
                                     c_int]),
        "mmb_sample_keyframes": (None, [ctypes.POINTER(p_u8), p_long, c_long, c_long, c_long,
                                        p_u8, p_f32, c_int]),
        "mmb_codecs": (c_int, []),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _load() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None where there is no
    compiler or the build failed (that warns, once)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        cxx = shutil.which("g++")
        if cxx is None:
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(build(cxx)))
            _bind(lib)
        except (RuntimeError, OSError, AttributeError, subprocess.TimeoutExpired) as e:
            warnings.warn(f"the native decode runtime did not build; every image decodes "
                          f"through PIL: {e}", RuntimeWarning, stacklevel=3)
            _build_failed = True
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def native_codecs() -> tuple[str, ...]:
    """The image formats the native build decodes (``"png"``, ``"jpeg"``);
    empty where there is no native library."""
    lib = _load()
    if lib is None:
        return ()
    bits = lib.mmb_codecs()
    return tuple(name for name, bit in _CODEC_BITS.items() if bits & bit)


def wav_decode(data: bytes, max_samples: int = 1 << 26) -> tuple[np.ndarray, int]:
    """WAV bytes → (mono float32 waveform, sample_rate). C++ path w/ fallback."""
    lib = _load()
    if lib is not None:
        out = np.empty(min(max_samples, len(data)), np.float32)
        sr = ctypes.c_int(0)
        n = lib.mmb_wav_decode(
            data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(out),
            ctypes.byref(sr),
        )
        if n >= 0:
            return out[:n].copy(), sr.value
    # Python fallback via stdlib wave
    import wave as wave_mod

    with wave_mod.open(io.BytesIO(data), "rb") as w:
        sr_v = w.getframerate()
        raw = w.readframes(w.getnframes())
        width, channels = w.getsampwidth(), w.getnchannels()
    if width == 2:
        arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        arr = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        # 24-bit packed PCM etc: refusing beats silently reinterpreting the
        # packed bytes as u8 noise (same contract as data/video.py::load_wav)
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        arr = arr.reshape(-1, channels).mean(axis=1)
    return arr[:max_samples], sr_v


def pil_decode(data: bytes) -> np.ndarray:
    """Image bytes → [H, W, 3] uint8 through PIL, counted in ``decode_counts``."""
    from PIL import Image

    out = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(np.uint8)
    _count("pil")
    return out


def ppm_decode(data: bytes) -> np.ndarray:
    """P6 PPM bytes → [H, W, 3] uint8."""
    lib = _load()
    if lib is not None:
        w = ctypes.c_long(0)
        h = ctypes.c_long(0)
        if lib.mmb_ppm_header(data, len(data), ctypes.byref(w), ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            rc = lib.mmb_ppm_decode(
                data, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
            )
            if rc == 0:
                _count("native")
                return out
    return pil_decode(data)


def image_decode(data: bytes) -> np.ndarray:
    """PNG/JPEG bytes → [H, W, 3] uint8 (libpng/libjpeg off the GIL,
    format sniffed by magic bytes; PIL fallback)."""
    lib = _load()
    if lib is not None:
        w = ctypes.c_long(0)
        h = ctypes.c_long(0)
        if lib.mmb_image_header(data, len(data), ctypes.byref(w), ctypes.byref(h)) == 0:
            out = np.empty((h.value, w.value, 3), np.uint8)
            n = lib.mmb_image_decode(
                data, len(data),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size,
            )
            if n == out.size:
                _count("native")
                return out
    return pil_decode(data)


def image_decode_batch(blobs: list[bytes], num_threads: int = 4) -> list[np.ndarray]:
    """Decode many PNG/JPEG blobs with the C++ thread pool (serving's
    host-decode hot path — one call per keyframe dir instead of one
    GIL-bound PIL decode per frame). Falls back to per-image decode when
    the native lib is absent or a header does not parse."""
    lib = _load()
    if lib is None or not blobs:
        return [image_decode(b) for b in blobs]
    B = len(blobs)
    dims: list[tuple[int, int] | None] = []
    w = ctypes.c_long(0)
    h = ctypes.c_long(0)
    for b in blobs:
        ok = lib.mmb_image_header(b, len(b), ctypes.byref(w), ctypes.byref(h)) == 0
        dims.append((h.value, w.value) if ok else None)
    if any(d is None for d in dims):
        return [image_decode(b) for b in blobs]
    outs = [np.empty(d + (3,), np.uint8) for d in dims]
    datas = (ctypes.c_char_p * B)(*blobs)
    lens = (ctypes.c_long * B)(*[len(b) for b in blobs])
    ptrs = (ctypes.POINTER(ctypes.c_uint8) * B)(
        *[o.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for o in outs]
    )
    caps = (ctypes.c_long * B)(*[o.size for o in outs])
    written = (ctypes.c_long * B)()
    lib.mmb_image_decode_batch(datas, lens, B, ptrs, caps, written, num_threads)
    done = [written[i] == o.size for i, o in enumerate(outs)]
    _count("native", sum(done))
    return [o if ok else image_decode(blobs[i]) for i, (o, ok) in enumerate(zip(outs, done))]


# back-compat names (PNG was the first format wired in)
png_decode = image_decode
png_decode_batch = image_decode_batch


def pad_waveforms(waves: list[np.ndarray], num_samples: int, num_threads: int = 4) -> np.ndarray:
    """Variable-length float32 waveforms → zero-padded [B, num_samples]."""
    B = len(waves)
    out = np.empty((B, num_samples), np.float32)
    lib = _load()
    if lib is not None:
        waves = [np.ascontiguousarray(w, np.float32) for w in waves]
        ptrs = (ctypes.POINTER(ctypes.c_float) * B)(
            *[w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)) for w in waves]
        )
        lengths = (ctypes.c_long * B)(*[len(w) for w in waves])
        lib.mmb_pad_waveforms(
            ptrs, lengths, B, num_samples,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads,
        )
        return out
    out[:] = 0.0
    for i, w in enumerate(waves):
        n = min(len(w), num_samples)
        out[i, :n] = w[:n]
    return out


def sample_keyframes_batch(
    videos: list[np.ndarray], max_k: int, num_threads: int = 4
) -> tuple[np.ndarray, np.ndarray]:
    """Batch every-N keyframe sampling: list of [T_i, H, W, 3] uint8 →
    ([B, max_k, H, W, 3], mask [B, max_k]). Same policy as data/video.py."""
    B = len(videos)
    shape = videos[0].shape[1:]
    frame_bytes = int(np.prod(shape))
    out = np.empty((B, max_k) + shape, np.uint8)
    mask = np.empty((B, max_k), np.float32)
    lib = _load()
    if lib is not None:
        videos = [np.ascontiguousarray(v, np.uint8) for v in videos]
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * B)(
            *[v.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) for v in videos]
        )
        counts = (ctypes.c_long * B)(*[v.shape[0] for v in videos])
        lib.mmb_sample_keyframes(
            ptrs, counts, frame_bytes, B, max_k,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads,
        )
        return out, mask
    from mmbidaf_tpu_torch.data.video import sample_keyframes

    outs, masks = zip(*(sample_keyframes(v, max_k) for v in videos))
    return np.stack(outs), np.stack(masks)
