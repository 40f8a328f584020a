"""The port's native decode runtime (``mmbidaf_tpu_torch.native``) against
the JAX package's (``mmbidaf_tpu.native``): the cases of
``tests/test_native.py`` through both packages, ``load_image_dir`` of both
bit for bit on PNG, JPEG and mixed directories, the MJPEG container decode,
the build keyed by a hash of its source and flags, the codecs the build
reports, the decode counters, and every fallback to PIL.

Tolerance: none. Both packages run the same C++ source over the same
libpng / libjpeg, and PIL links the same libjpeg, so every array is equal
bit for bit (the 24-bit WAV refusal is an exception, not an array).
"""

import io
import shutil
import wave as wave_mod

import numpy as np
import pytest
from PIL import Image

from mmbidaf_tpu import native as j_native
from mmbidaf_tpu.data import containers as j_containers
from mmbidaf_tpu.data import video as j_video
from mmbidaf_tpu_torch import native
from mmbidaf_tpu_torch.data import containers, video
from mmbidaf_tpu_torch.native import loader


@pytest.fixture(autouse=True)
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native runtime")
    if not native.native_available():
        pytest.fail("the native library did not build, though g++ is on this host")
    return loader._lib


def _wav_bytes(sig_int16, sr=8000, channels=1):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(sig_int16.tobytes())
    return buf.getvalue()


def _png(arr_or_img) -> bytes:
    img = arr_or_img if isinstance(arr_or_img, Image.Image) else Image.fromarray(arr_or_img)
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def _jpg(img, q=90) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", quality=q)
    return buf.getvalue()


def _equal(a, b, msg=""):
    assert a.dtype == b.dtype and a.shape == b.shape, msg
    np.testing.assert_array_equal(a, b, err_msg=msg)


def test_codecs_and_build_key():
    """This host has libpng and libjpeg: the build links both; the library's
    name is keyed on the source and the probed flags."""
    assert native.native_codecs() == ("png", "jpeg")
    flags = loader.build_flags()
    assert "-DMMB_HAVE_PNG" in flags and "-lpng" in flags and "-DMMB_HAVE_JPEG" in flags
    path = loader.library_path(flags)
    assert path.exists() and path.parent == loader.BUILD_DIR
    assert loader.library_path(flags[:-2]) != path  # other flags, another library


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_decode_matches_jax(rng, channels):
    sig = (rng.standard_normal(3000 * channels) * 15000).astype(np.int16)
    data = _wav_bytes(sig, channels=channels)
    wave, sr = native.wav_decode(data)
    j_wave, j_sr = j_native.wav_decode(data)
    assert sr == j_sr == 8000
    _equal(wave, j_wave)
    if channels == 1:
        np.testing.assert_allclose(wave, sig.astype(np.float32) / 32768.0, atol=1e-6)


def test_wav_fallback_rejects_24bit(monkeypatch):
    buf = io.BytesIO()
    with wave_mod.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(b"\x00\x01\x02" * 64)
    monkeypatch.setattr(loader, "_load", lambda: None)
    with pytest.raises(ValueError, match="sample width"):
        loader.wav_decode(buf.getvalue())


def test_ppm_decode_matches_jax(rng):
    pix = (rng.random((7, 5, 3)) * 255).astype(np.uint8)
    data = b"P6\n# comment\n5 7\n255\n" + pix.tobytes()
    _equal(native.ppm_decode(data), pix)
    _equal(native.ppm_decode(data), j_native.ppm_decode(data))


def test_pad_waveforms_matches_jax(rng):
    waves = [rng.standard_normal(n).astype(np.float32) for n in (100, 50, 130)]
    _equal(native.pad_waveforms(waves, 120), j_native.pad_waveforms(waves, 120))


def test_sample_keyframes_batch_matches_jax(rng):
    videos = [(rng.random((t, 6, 4, 3)) * 255).astype(np.uint8) for t in (10, 3, 17)]
    out, mask = native.sample_keyframes_batch(videos, 5)
    j_out, j_mask = j_native.sample_keyframes_batch(videos, 5)
    _equal(out, j_out)
    _equal(mask, j_mask)
    for b, v in enumerate(videos):
        ref, ref_mask = video.sample_keyframes(v, 5)
        _equal(out[b], ref)
        _equal(mask[b], ref_mask)


def test_png_variants_match_jax_and_pil(rng):
    """RGB / gray / palette / alpha PNGs: native == PIL == JAX's native;
    16-bit: libpng's strip (>> 8), as in the JAX package (PIL clamps)."""
    rgb = Image.fromarray((rng.random((21, 17, 3)) * 255).astype(np.uint8))
    for img in (rgb, rgb.convert("L"), rgb.convert("P", palette=Image.ADAPTIVE, colors=16),
                rgb.convert("RGBA")):
        data = _png(img)
        got = native.png_decode(data)
        _equal(got, np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img.mode)
        _equal(got, j_native.png_decode(data), img.mode)
    raw16 = (rng.random((9, 11)) * 65535).astype(np.uint16)
    data = _png(Image.fromarray(raw16))
    _equal(native.png_decode(data), np.repeat((raw16 >> 8).astype(np.uint8)[:, :, None], 3, 2))
    _equal(native.png_decode(data), j_native.png_decode(data))


def test_jpeg_matches_jax_and_pil(rng):
    rgb = Image.fromarray((rng.random((20, 24, 3)) * 255).astype(np.uint8))
    blobs = [_jpg(rgb), _jpg(rgb.convert("L")), _jpg(rgb, q=75)]
    for b in blobs:
        got = native.image_decode(b)
        _equal(got, np.asarray(Image.open(io.BytesIO(b)).convert("RGB")))
        _equal(got, j_native.image_decode(b))
    for o, j in zip(native.image_decode_batch(blobs, num_threads=2),
                    j_native.image_decode_batch(blobs, num_threads=2)):
        _equal(o, j)


def test_batch_threaded_and_counted(rng):
    blobs = [_png((rng.random((8 + i, 12, 3)) * 255).astype(np.uint8)) for i in range(6)]
    before = dict(native.decode_counts)
    outs = native.png_decode_batch(blobs, num_threads=3)
    assert native.decode_counts["native"] == before["native"] + 6
    assert native.decode_counts["pil"] == before["pil"]
    for i, (o, b) in enumerate(zip(outs, blobs)):
        assert o.shape == (8 + i, 12, 3)
        _equal(o, native.png_decode(b))


def test_malformed_and_unbuilt_formats_fall_back_to_pil(rng, monkeypatch):
    """A malformed blob goes to PIL (which raises, as in JAX); a BMP, which
    the build has no codec for, decodes through PIL and is counted there;
    with no library at all every image decodes through PIL."""
    with pytest.raises(Exception):
        native.png_decode(b"not a png at all")
    with pytest.raises(Exception):
        native.png_decode_batch([b"also not a png"])
    arr = (rng.random((5, 6, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="BMP")
    before = dict(native.decode_counts)
    _equal(native.image_decode(buf.getvalue()), arr)
    assert native.decode_counts["pil"] == before["pil"] + 1
    assert native.decode_counts["native"] == before["native"]
    monkeypatch.setattr(loader, "_load", lambda: None)
    assert not loader.native_available() and loader.native_codecs() == ()
    before = dict(native.decode_counts)
    data = _png(arr)
    _equal(loader.image_decode_batch([data, data])[1], arr)
    assert native.decode_counts["pil"] == before["pil"] + 2


def test_no_compiler_means_pil(monkeypatch):
    """Where no g++ is found nothing is built and nothing warns: every
    image decodes through PIL."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_failed", False)
    monkeypatch.setattr(loader.shutil, "which", lambda name: None)
    assert not loader.native_available()


def test_failed_build_warns_and_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_failed", False)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", bad)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    with pytest.warns(RuntimeWarning, match="did not build"):
        assert loader._load() is None
    assert not loader.native_available()


def _write_frames(d, frames, exts):
    d.mkdir()
    for i, (fr, ext) in enumerate(zip(frames, exts)):
        Image.fromarray(fr).save(d / f"f{i:03d}.{ext}", **({"quality": 95} if ext != "png" else {}))


@pytest.mark.parametrize("exts", [("png",) * 4, ("jpg", "jpeg", "jpg"), ("jpg", "png", "jpeg"),
                                  ("png", "ppm")])
def test_load_image_dir_matches_jax(tmp_path, rng, exts):
    """All-PNG and all-JPEG and mixed PNG/JPEG directories decode natively
    (counted so); a directory with another format goes through PIL; each
    equals the JAX package's ``load_image_dir`` bit for bit."""
    frames = [(rng.random((10, 14, 3)) * 255).astype(np.uint8) for _ in exts]
    _write_frames(tmp_path / "v", frames, exts)
    before = dict(native.decode_counts)
    ours = video.load_image_dir(str(tmp_path / "v"))
    native_path = set(exts) <= {"png", "jpg", "jpeg"}
    assert native.decode_counts["native"] - before["native"] == (len(exts) if native_path else 0)
    assert native.decode_counts["pil"] - before["pil"] == (0 if native_path else len(exts))
    _equal(ours, j_video.load_image_dir(str(tmp_path / "v")))
    for i, ext in enumerate(exts):
        if ext in ("png", "ppm"):
            _equal(ours[i], frames[i])


def test_mjpeg_container_decodes_natively(tmp_path, rng):
    frames = (rng.random((5, 16, 24, 3)) * 255).astype(np.uint8)
    wave = (rng.standard_normal(1600) * 0.1).astype(np.float32)
    path = str(tmp_path / "v.avi")
    containers.write_mjpeg_avi(path, frames, waveform=wave, sample_rate=8000)
    before = native.decode_counts["native"]
    ours = containers.decode_container(path)
    assert native.decode_counts["native"] == before + 5
    theirs = j_containers.decode_container(path)
    _equal(ours[0], theirs[0])
    _equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]
