"""Host-side asset decode, the port's copy of ``mmbidaf_tpu.data.video``
(SURVEY.md §4.1): the only stage that stays on
the host — mp4/image/wav → arrays. Everything downstream (resize, VGG, DFT,
mel) runs inside jit (data/frontend.py).

The reference shells out to ffmpeg/OpenCV per video. This image has neither;
decode is a plug-in surface with built-in decoders for what the environment
supports (PNG/JPEG through the native runtime, other image files via PIL,
WAV via stdlib ``wave``, ``.npy``/``.npz`` pre-extracted arrays), plus an
optional ffmpeg path that activates when an ``ffmpeg`` binary exists.
Keyframe *sampling* policy (every-N) lives here.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import wave as wave_mod
import numpy as np


def sample_keyframes(frames: np.ndarray, max_keyframes: int) -> tuple[np.ndarray, np.ndarray]:
    """Every-N sampling of ``[T, H, W, 3]`` frames → exactly ``max_keyframes``
    (padded with zeros) + mask. Mirrors the reference's every-N policy."""
    T = frames.shape[0]
    if T == 0:
        raise ValueError("no frames to sample")
    n = min(T, max_keyframes)
    # floor(x + 0.5) (not np.round's half-to-even) — keeps the C++ batch
    # batch sampler of the JAX package's native/ bit-identical to this policy.
    idx = np.floor(np.linspace(0, T - 1, n) + 0.5).astype(np.int64)
    out = np.zeros((max_keyframes,) + frames.shape[1:], frames.dtype)
    out[:n] = frames[idx]
    mask = (np.arange(max_keyframes) < n).astype(np.float32)
    return out, mask


def sample_keyframes_shot_change(
    frames: np.ndarray, max_keyframes: int, min_gap: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Shot-change sampling (the reference's other policy, SURVEY §3.1):
    pick the frames with the largest content change from their predecessor
    (mean |Δ| over downsampled pixels), at least ``min_gap`` apart, emitted
    in temporal order. Falls back to every-N when fewer shots than slots.
    """
    T = frames.shape[0]
    if T == 0:
        raise ValueError("no frames to sample")
    if T <= max_keyframes:
        return sample_keyframes(frames, max_keyframes)
    small = frames[:, ::4, ::4, :].astype(np.float32)
    diff = np.abs(small[1:] - small[:-1]).mean(axis=(1, 2, 3))  # [T-1]
    picked = [0]  # always anchor the first frame
    for i in np.argsort(diff)[::-1]:  # largest scene change first
        t = int(i) + 1
        if all(abs(t - p) >= min_gap for p in picked):
            picked.append(t)
            if len(picked) == max_keyframes:
                break
    idx = np.sort(np.asarray(picked, np.int64))
    n = len(idx)
    out = np.zeros((max_keyframes,) + frames.shape[1:], frames.dtype)
    out[:n] = frames[idx]
    mask = (np.arange(max_keyframes) < n).astype(np.float32)
    return out, mask


IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp")


def load_image_dir(path: str) -> np.ndarray:
    """Directory of image files (sorted) → ``[T, H, W, 3] uint8``.

    PNG/JPEG directories decode through the C++ thread pool
    (`native.image_decode_batch`, off the GIL); anything else via PIL.
    """
    names = sorted(
        f for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTS)
    )
    if not names:
        raise FileNotFoundError(f"no images in {path}")
    from mmbidaf_tpu_torch.native import loader

    blobs = []
    for n in names:
        with open(os.path.join(path, n), "rb") as f:
            blobs.append(f.read())
    if all(n.lower().endswith((".png", ".jpg", ".jpeg")) for n in names):
        return np.stack(loader.image_decode_batch(blobs)).astype(np.uint8)
    return np.stack([loader.pil_decode(b) for b in blobs]).astype(np.uint8)


def load_wav(path: str) -> tuple[np.ndarray, int]:
    """WAV file → (mono float32 waveform in [-1, 1], sample_rate)."""
    with wave_mod.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        width = w.getsampwidth()
        channels = w.getnchannels()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


def pad_waveform(wave: np.ndarray, num_samples: int) -> tuple[np.ndarray, int]:
    """Pad/truncate to the static length the jitted frontend expects.
    Returns (padded, valid_samples)."""
    out = np.zeros((num_samples,), np.float32)
    n = min(len(wave), num_samples)
    out[:n] = wave[:n]
    return out, n


def audio_frames_valid(n_samples: int, hop_length: int, max_frames: int) -> int:
    """Number of MFCC frames touching real (non-padding) samples: frame t
    covers samples [t·hop, t·hop+win), so frames with t·hop < n are valid.
    Masks built from this make T_aud bucketing semantics-preserving (the
    masked LSTM/attention never look past the real audio)."""
    if n_samples <= 0:
        return 1  # a silent track still occupies one (masked-softmax-safe) frame
    return int(min(max_frames, -(-n_samples // hop_length)))


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def decode_video_ffmpeg(
    path: str,
    fps: float = 1.0,
    size: tuple[int, int] = (240, 320),
    every_n: int | None = None,
    max_frames: int | None = None,
) -> np.ndarray:
    """mp4 → ``[T, H, W, 3] uint8`` via an ffmpeg rawvideo pipe (activates
    only where an ffmpeg binary exists; absent in this image).

    ``every_n`` switches from fps resampling to an exact source-frame
    stride (``select=not(mod(n,N))`` — the corpus importers' sampling
    semantics, independent of the container's frame rate); ``max_frames``
    caps the decoded count on the ffmpeg side (``-frames:v``)."""
    if not ffmpeg_available():
        raise RuntimeError("ffmpeg binary not available")
    h, w = size
    if every_n is not None:
        vf = f"select=not(mod(n\\,{every_n})),scale={w}:{h}"
        rate = ["-fps_mode", "vfr"]  # keep selected frames, don't re-time
    else:
        vf = f"fps={fps},scale={w}:{h}"
        rate = []
    cap = ["-frames:v", str(max_frames)] if max_frames is not None else []
    cmd = [
        "ffmpeg", "-v", "error", "-i", path, "-vf", vf, *rate, *cap,
        "-f", "rawvideo", "-pix_fmt", "rgb24", "-",
    ]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    n = len(raw) // (h * w * 3)
    return np.frombuffer(raw[: n * h * w * 3], np.uint8).reshape(n, h, w, 3)


def extract_audio_ffmpeg(path: str, sample_rate: int = 16000) -> np.ndarray:
    """mp4 → mono float32 PCM via ffmpeg (optional, see above)."""
    if not ffmpeg_available():
        raise RuntimeError("ffmpeg binary not available")
    cmd = [
        "ffmpeg", "-v", "error", "-i", path, "-ac", "1", "-ar", str(sample_rate),
        "-f", "f32le", "-",
    ]
    raw = subprocess.run(cmd, capture_output=True, check=True).stdout
    return np.frombuffer(raw, np.float32)


def extract_media_to_dir(
    video_path: str,
    vdir: str,
    every_n: int = 30,
    max_frames: int = 64,
    sample_rate: int = 16000,
) -> bool:
    """Decode a container into the VideoCorpus media layout: sampled
    keyframes → ``vdir/frames/fNNNN.png``, audio track → ``vdir/audio.wav``
    (the shared tail of the corpus importers). Returns False when ffmpeg
    is unavailable (caller decides whether to copy the container instead).
    """
    from mmbidaf_tpu_torch.data import containers

    ext = os.path.splitext(video_path)[1].lower()
    pcm = None
    if ffmpeg_available():
        frames = decode_video_ffmpeg(video_path, every_n=every_n, max_frames=max_frames)
        pcm = extract_audio_ffmpeg(video_path, sample_rate)
    elif ext in (".y4m", ".avi"):
        # No ffmpeg: the vendored container parsers cover y4m / MJPEG-AVI
        # (data/containers.py) so imports still produce real media dirs.
        frames, pcm, sr = containers.decode_container(
            video_path, every_n=every_n, max_frames=max_frames
        )
        if pcm is not None and sr:
            pcm = containers.resample_linear(pcm, sr, sample_rate)
    else:
        return False
    from PIL import Image

    fdir = os.path.join(vdir, "frames")
    os.makedirs(fdir, exist_ok=True)
    for i, fr in enumerate(frames):
        Image.fromarray(fr).save(os.path.join(fdir, f"f{i:04d}.png"))
    if pcm is not None:
        with wave_mod.open(os.path.join(vdir, "audio.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes((np.clip(pcm, -1, 1) * 32767).astype(np.int16).tobytes())
    return True


def load_video_assets(
    video_dir: str,
    max_keyframes: int,
    num_audio_samples: int,
    media: bool = True,
    keyframe_policy: str = "every_n",
    sample_rate: int = 16000,
) -> dict:
    """Per-video asset directory → raw arrays for the device frontend.

    Layout (corpus-agnostic, SURVEY §1): ``frames/`` image dir OR
    ``frames.npy``; ``audio.wav`` OR ``audio.npy``; ``transcript.txt``;
    optional ``summary.txt`` (gold). ``media=False`` reads only the text
    sidecars (precomputed-feature corpora skip the decode entirely).
    """
    if not media:
        with open(os.path.join(video_dir, "transcript.txt")) as f:
            transcript = f.read()
        summary = None
        spath = os.path.join(video_dir, "summary.txt")
        if os.path.exists(spath):
            with open(spath) as f:
                summary = f.read()
        return {"frames": None, "img_mask": None, "waveform": None,
                "transcript": transcript, "summary": summary}
    sampler = (sample_keyframes_shot_change if keyframe_policy == "shot_change"
               else sample_keyframes)
    container_wave = container_sr = None
    fdir = os.path.join(video_dir, "frames")
    if os.path.exists(os.path.join(video_dir, "frames.npy")):
        frames = np.load(os.path.join(video_dir, "frames.npy"))
        frames, img_mask = sampler(frames, max_keyframes)
    elif os.path.isdir(fdir):
        frames = load_image_dir(fdir)
        frames, img_mask = sampler(frames, max_keyframes)
    else:
        from mmbidaf_tpu_torch.data import containers

        cpath = containers.find_container(video_dir)
        if cpath is not None:
            # Raw container in the asset dir (the reference's "mp4 +
            # transcript" I/O contract, SURVEY §1): decode video + any
            # embedded audio track here on the host; .y4m/MJPEG-.avi go
            # through the vendored parsers, the rest through ffmpeg.
            frames, container_wave, container_sr = containers.decode_container(cpath)
            frames, img_mask = sampler(frames, max_keyframes)
            if (container_wave is None and ffmpeg_available()
                    and os.path.splitext(cpath)[1].lower() not in (".y4m",)):
                try:
                    container_wave = extract_audio_ffmpeg(cpath, sample_rate)
                    container_sr = sample_rate
                except Exception:
                    container_wave = None
        else:
            # Media-less (text-only) import: zero frames, fully-masked — the
            # image tower sees nothing; --no_images configs skip it entirely.
            frames = np.zeros((max_keyframes, 8, 8, 3), np.uint8)
            img_mask = np.zeros((max_keyframes,), np.float32)

    if os.path.exists(os.path.join(video_dir, "audio.npy")):
        wave = np.load(os.path.join(video_dir, "audio.npy")).astype(np.float32)
    elif os.path.exists(os.path.join(video_dir, "audio.wav")):
        wave, _ = load_wav(os.path.join(video_dir, "audio.wav"))
    elif container_wave is not None:
        from mmbidaf_tpu_torch.data.containers import resample_linear

        wave = resample_linear(container_wave, container_sr or sample_rate,
                               sample_rate)
    else:
        wave = np.zeros((num_audio_samples,), np.float32)  # silent track
    # valid count = min(len(wave), num_audio_samples) — pad_waveform's return
    wave, n_valid = pad_waveform(wave, num_audio_samples)

    with open(os.path.join(video_dir, "transcript.txt")) as f:
        transcript = f.read()
    summary = None
    spath = os.path.join(video_dir, "summary.txt")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = f.read()
    return {
        "frames": frames,
        "img_mask": img_mask,
        "waveform": wave,
        "valid_samples": n_valid,
        "transcript": transcript,
        "summary": summary,
    }
