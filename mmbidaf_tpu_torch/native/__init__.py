"""The host-side decode runtime (C++ thread pool, libpng / libjpeg), the
port's copy of ``mmbidaf_tpu.native``; see ``loader``."""

from mmbidaf_tpu_torch.native.loader import (  # noqa: F401
    decode_counts,
    image_decode,
    image_decode_batch,
    native_available,
    native_codecs,
    pad_waveforms,
    png_decode,
    png_decode_batch,
    ppm_decode,
    sample_keyframes_batch,
    wav_decode,
)
